"""Arabic diacritic restoration (libtashkeel algorithm).

Port of ``phoonnx_tpu/thirdparty/tashkeel`` (a capability rebuild of
phoonnx/thirdparty/tashkeel, itself a Python port of mush42/libtashkeel):
character/diacritic extraction with hint maps, the model inference over
(char_inputs, diac_inputs, input_lengths), and the taskeen (sukoon)
threshold logic, all verbatim. The ONNX model runs op by op on the
diacritizer's device through
:class:`phoonnx_tpu_torch.onnx.torch_lowering.TorchGraphRunner`
(:func:`phoonnx_tpu_torch.onnx.aux_compile.compiled_runner`), padded to
:func:`~phoonnx_tpu_torch.onnx.aux_compile.bucket_len` buckets; there is
no interpreter fallback, and a runner failure raises. When
``model.onnx`` is absent (it is a large blob not shipped with the
reference checkout either) the diacritizer degrades to identity with a
warning so synthesis still works on undiacritized text.
"""

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

LOG = logging.getLogger(__name__)

TASHKEEL_DIR = Path(__file__).parent
CHAR_LIMIT = 12000
PAD = "_"
NUMERAL_SYMBOL = "#"
NUMERALS = set("0123456789٠١٢٣٤٥٦٧٨٩")
ARABIC_DIACRITICS = set(map(chr, [1618, 1617, 1614, 1615, 1616, 1611, 1612,
                                  1613]))
# shadda+haraka sequences normalised to their composed order
# haraka+shadda (the codepoint order common in real text) -> the
# composed shadda+haraka order hint_id_map.json actually contains.
# Written with escapes: bidi rendering made a literal transcription
# silently map every key to ITSELF, so normalization was a no-op and
# hint_id_map[d] raised KeyError on haraka-first input.
NORMALIZED_DIAC_MAP = {
    "\u064e\u0651": "\u0651\u064e",
    "\u064b\u0651": "\u0651\u064b",
    "\u064f\u0651": "\u0651\u064f",
    "\u064c\u0651": "\u0651\u064c",
    "\u0650\u0651": "\u0651\u0650",
    "\u064d\u0651": "\u0651\u064d",
}
SUKOON = chr(0x652)


class TashkeelError(Exception):
    pass


class TashkeelDiacritizer:
    """Add diacritics to Arabic text (identity fallback without a model)."""

    def __init__(self, model_dir: Union[str, Path] = TASHKEEL_DIR,
                 device=None):
        """device: where the model runs; None means the GPU (and raises
        without one), ``"cpu"`` the host's torch."""
        from phoonnx_tpu_torch.infer.engine import resolve_device

        self.device = resolve_device(device)
        model_dir = Path(model_dir)
        self.model_dir = model_dir

        with open(model_dir / "input_id_map.json", encoding="utf-8") as f:
            self.input_id_map: Dict[str, int] = json.load(f)
        with open(model_dir / "target_id_map.json", encoding="utf-8") as f:
            target_id_map: Dict[str, int] = json.load(f)
        self.id_target_map = {i: c for c, i in target_id_map.items()}
        self.target_id_meta_chars: Set[int] = {target_id_map[PAD]}
        with open(model_dir / "hint_id_map.json", encoding="utf-8") as f:
            self.hint_id_map: Dict[str, int] = json.load(f)

        self._runner = None
        self._pad_checked = False
        self._pad_ok = True  # False: exact lengths on the runner
        self._load_attempted = False

    # -- model ----------------------------------------------------------

    def _get_executor(self):
        """The model's runner on this diacritizer's device, or None when
        ``model.onnx`` is absent."""
        if not self._load_attempted:
            self._load_attempted = True
            model_path = self.model_dir / "model.onnx"
            if model_path.exists():
                from phoonnx_tpu_torch.onnx.aux_compile import compiled_runner
                from phoonnx_tpu_torch.onnx.reader import read_onnx

                self._runner = compiled_runner(
                    read_onnx(str(model_path)), device=self.device,
                    matmul_precision="highest")
            else:
                LOG.warning(
                    "tashkeel model.onnx not found in %s — diacritization "
                    "disabled (returning text unchanged)", self.model_dir,
                )
        return self._runner

    def _feeds(self, input_ids: List[int], diac_ids: List[int],
               seq_length: int, pad_to: int) -> Dict[str, np.ndarray]:
        pad_id = self.input_id_map.get(PAD, 0)
        char = np.full((1, pad_to), pad_id, np.int64)
        char[0, :seq_length] = input_ids
        diac = np.zeros((1, pad_to), np.int64)
        diac[0, :seq_length] = diac_ids
        return {"char_inputs": char, "diac_inputs": diac,
                "input_lengths": np.asarray([seq_length], np.int64)}

    @staticmethod
    def _slice_outputs(outputs, pad_to: int,
                       seq_length: int) -> Tuple[List[int], List[float]]:
        def trim(arr):
            arr = np.asarray(arr)
            if pad_to != seq_length and arr.ndim and \
                    arr.shape[-1] == pad_to:
                arr = arr[..., :seq_length]
            return arr
        target_ids = trim(outputs[0]).flatten().astype(np.uint8).tolist()
        logits = trim(outputs[1]).flatten().astype(np.float32).tolist()
        return target_ids, logits

    def _infer(self, input_ids: List[int], diac_ids: List[int],
               seq_length: int) -> Tuple[List[int], List[float]]:
        """Run the model on its runner, the sequence padded to a length
        bucket and the outputs sliced back.

        Padding soundness rests on the model masking by its
        ``input_lengths`` input (the libtashkeel contract) — verified
        once per diacritizer by comparing the first bucketed result
        against an exact-length run on the same runner and device; on
        mismatch every later call runs exact lengths on that runner.
        """
        from phoonnx_tpu_torch.onnx.aux_compile import bucket_len

        runner = self._get_executor()
        pad_to = bucket_len(seq_length) if self._pad_ok else seq_length
        got = self._slice_outputs(
            runner.run(self._feeds(input_ids, diac_ids, seq_length, pad_to)),
            pad_to, seq_length)
        if self._pad_checked or pad_to == seq_length:
            return got
        self._pad_checked = True
        exact = self._slice_outputs(
            runner.run(self._feeds(input_ids, diac_ids, seq_length,
                                   seq_length)),
            seq_length, seq_length)
        if got[0] == exact[0] and np.allclose(
                got[1], exact[1], rtol=1e-3, atol=1e-3):
            return got
        LOG.warning(
            "tashkeel model output changes under length padding "
            "(input_lengths not honored?) — disabling the compiled "
            "bucketed path for this session")
        self._pad_ok = False
        return exact

    # -- public API -----------------------------------------------------

    def __call__(self, text: str,
                 taskeen_threshold: Optional[float] = None) -> str:
        return self.diacritize(text, taskeen_threshold)

    def diacritize(self, text: str,
                   taskeen_threshold: Optional[float] = None) -> str:
        text = text.strip()
        if len(text) > CHAR_LIMIT:
            raise TashkeelError(f"Text length cannot exceed {CHAR_LIMIT}")
        if self._get_executor() is None:
            return text

        input_text, removed_chars = self._to_valid_chars(text)
        input_text, diacritics = self._extract_chars_and_diacritics(
            input_text, normalize_diacritics=True
        )
        input_ids = [self.input_id_map[c] for c in input_text]
        diac_ids = [self.hint_id_map[d] for d in diacritics]
        if not input_ids:
            return text

        target_ids, logits = self._infer(input_ids, diac_ids, len(input_ids))
        predicted = [
            self.id_target_map[i]
            for i in target_ids
            if i not in self.target_id_meta_chars
        ]
        if taskeen_threshold is None:
            return self._annotate(text, predicted, removed_chars)
        return self._annotate_taskeen(text, predicted, removed_chars,
                                      logits, taskeen_threshold)

    # -- text helpers ---------------------------------------------------

    @staticmethod
    def _is_diacritic(c: str) -> bool:
        return c in ARABIC_DIACRITICS

    def _annotate(self, input_text: str, diacritics: List[str],
                  removed_chars: Set[str]) -> str:
        out: List[str] = []
        diac_iter = iter(diacritics)
        for c in input_text:
            if self._is_diacritic(c):
                continue
            out.append(c)
            if c not in removed_chars:
                out.append(next(diac_iter, ""))
        return "".join(out)

    def _annotate_taskeen(self, input_text: str, diacritics: List[str],
                          removed_chars: Set[str], logits: List[float],
                          threshold: float) -> str:
        out: List[str] = []
        diac_iter = zip(diacritics, logits)
        for c in input_text:
            if self._is_diacritic(c):
                continue
            out.append(c)
            if c not in removed_chars:
                diac, logit = next(diac_iter, ("", 0.0))
                out.append(SUKOON if logit > threshold else diac)
        return "".join(out)

    def _extract_chars_and_diacritics(
        self, text: str, normalize_diacritics: bool = True
    ) -> Tuple[str, List[str]]:
        text = text.lstrip("".join(ARABIC_DIACRITICS))
        clean_chars: List[str] = []
        diacritics: List[str] = []
        pending = ""
        for c in list(text) + [" "]:
            if self._is_diacritic(c):
                pending += c
            else:
                clean_chars.append(c)
                diacritics.append(pending)
                pending = ""
        if clean_chars:
            clean_chars.pop()
        if diacritics:
            diacritics.pop(0)
        if normalize_diacritics:
            for i, d in enumerate(diacritics):
                if d not in self.hint_id_map:
                    diacritics[i] = NORMALIZED_DIAC_MAP.get(d, "")
        return "".join(clean_chars), diacritics

    def _to_valid_chars(self, text: str) -> Tuple[str, Set[str]]:
        valid: List[str] = []
        invalid: Set[str] = set()
        for c in text:
            if c in self.input_id_map or c in ARABIC_DIACRITICS:
                valid.append(c)
            elif c in NUMERALS:
                valid.append(NUMERAL_SYMBOL)
            else:
                invalid.add(c)
        return "".join(valid), invalid
