"""Hebrew nikud (diacritic) restoration on a torch device.

Port of ``phoonnx_tpu/thirdparty/phonikud``. The reference wraps the
external phonikud-onnx package, which itself runs onnxruntime on an
auto-downloaded int8 model (phoonnx/thirdparty/phonikud/__init__.py:6-21).
This module keeps the JAX package's whole algorithm verbatim and runs the
model op by op on the diacritizer's device through
:class:`phoonnx_tpu_torch.onnx.torch_lowering.TorchGraphRunner`, whose int8
op family (QuantizeLinear/MatMulInteger/...) covers the quantized graph,
padded to :func:`~phoonnx_tpu_torch.onnx.aux_compile.bucket_len` buckets.
There is no interpreter fallback: a runner failure raises.

Model contract (phonikud-1.0.int8.onnx — a char-level BERT tagger,
dicta-il/dictabert-large-char-menaked with phonikud's enhanced-marks
head):

* inputs  ``input_ids`` [B, T] int64 (CLS + one id per character + SEP)
  and ``attention_mask`` [B, T] int64;
* outputs per position: ``nikud_logits`` [B, T, 29] over
  :data:`NIKUD_CLASSES` (index 1 = mater-lectionis → no mark),
  ``shin_logits`` [B, T, 2] (shin vs sin dot), and
  ``additional_logits`` [B, T, 3] — phonikud's enhanced marks
  (hatama/stress ``\\u05ab``, vocal shva ``\\u05bd``, morphological
  prefix boundary ``|``), binary heads thresholded at logit 0.

Character→id vocabulary resolution order: a ``vocab`` JSON map in the
model's ONNX metadata, else a ``vocab.json`` file next to the model.
Without a vocabulary (or without the model blob, which is a large blob
absent from the reference checkout too) the diacritizer degrades to
identity with a warning, so synthesis still works on text without
nikud.
"""

import json
import logging
import os
import unicodedata
from typing import Dict, List, Optional

import numpy as np

LOG = logging.getLogger(__name__)

MAT_LECT_TOKEN = "<MAT_LECT>"
# Per-char nikud classes (dictabert-char-menaked head): none, mater
# lectionis, dagesh, the points U+05B0-U+05BB, dagesh+point combos,
# qamats qatan (U+05C7) and its dagesh combo.
NIKUD_CLASSES = (
    ["", MAT_LECT_TOKEN, "ּ"]
    + [chr(c) for c in range(0x05B0, 0x05BC)]
    + ["ּ" + chr(c) for c in range(0x05B0, 0x05BC)]
    + ["ׇ", "ׇּ"]
)
SHIN_CLASSES = ("ׁ", "ׂ")  # shin dot, sin dot

# phonikud enhanced marks (additional_logits columns, in order)
HATAMA = "֫"       # stress (HEBREW ACCENT OLE)
VOCAL_SHVA = "ֽ"   # mobile shva (HEBREW POINT METEG)
PREFIX_SEP = "|"        # morphological prefix boundary

CHAR_LIMIT = 2046  # model positions minus CLS/SEP

_ALEF, _TAV = 0x05D0, 0x05EA
# marks this module may emit; stripped from input before prediction
_STRIP = set(
    [chr(c) for c in range(0x05B0, 0x05C8)] + [HATAMA, VOCAL_SHVA]
)


def _is_hebrew_letter(ch: str) -> bool:
    return _ALEF <= ord(ch) <= _TAV


def strip_nikud(text: str) -> str:
    """Remove nikud/cantillation marks (the model predicts from plain
    consonantal text; pre-pointed input would double-mark)."""
    text = unicodedata.normalize("NFD", text)
    return "".join(ch for ch in text if ch not in _STRIP)


class PhonikudDiacritizer:
    """Add nikud + phonikud enhanced marks to Hebrew text.

    Identity fallback when the model or its vocabulary is unavailable.
    """

    DL_URL = ("https://huggingface.co/thewh1teagle/phonikud-onnx/"
              "resolve/main/phonikud-1.0.int8.onnx")

    def __init__(self, model_path: Optional[str] = None, device=None):
        """device: where the model runs; None means the GPU (and raises
        without one), ``"cpu"`` the host's torch."""
        from phoonnx_tpu_torch.infer.engine import resolve_device

        self.device = resolve_device(device)
        self.model_path = model_path or os.path.expanduser(
            "~/.local/share/phoonnx/phonikud-1.0.int8.onnx"
        )
        self._runner = None
        self._pad_checked = False
        self._pad_ok = True  # False: exact lengths on the runner
        self._vocab: Optional[Dict[str, int]] = None
        self._output_names: List[str] = []
        self._tried = False

    # -- model loading ----------------------------------------------------

    def _download(self) -> bool:
        """Fetch the model on first use like the reference
        (phoonnx/thirdparty/phonikud/__init__.py:6-21)."""
        import urllib.request

        os.makedirs(os.path.dirname(self.model_path), exist_ok=True)
        tmp = self.model_path + ".part"
        try:
            LOG.info("downloading phonikud model from %s", self.DL_URL)
            with urllib.request.urlopen(self.DL_URL, timeout=60) as resp, \
                    open(tmp, "wb") as f:
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(tmp, self.model_path)
            return True
        except Exception as exc:
            if os.path.exists(tmp):
                os.remove(tmp)
            LOG.warning("phonikud model download failed (%s) — nikud "
                        "restoration disabled", exc)
            return False

    def _resolve_vocab(self, metadata: Dict[str, str]) -> Optional[dict]:
        if "vocab" in metadata:
            try:
                return {str(k): int(v)
                        for k, v in json.loads(metadata["vocab"]).items()}
            except (ValueError, AttributeError) as exc:
                LOG.warning("phonikud model metadata vocab unreadable: %s",
                            exc)
        side = os.path.join(os.path.dirname(self.model_path), "vocab.json")
        if os.path.exists(side):
            with open(side, encoding="utf-8") as f:
                return {str(k): int(v) for k, v in json.load(f).items()}
        return None

    def _load(self) -> bool:
        if self._tried:
            return self._runner is not None
        self._tried = True
        if not os.path.exists(self.model_path) and not self._download():
            return False
        from phoonnx_tpu_torch.onnx.aux_compile import compiled_runner
        from phoonnx_tpu_torch.onnx.reader import read_onnx

        model = read_onnx(self.model_path)
        vocab = self._resolve_vocab(model.metadata)
        if vocab is None:
            LOG.warning(
                "phonikud model has no character vocabulary (neither ONNX "
                "metadata 'vocab' nor vocab.json beside %s) — nikud "
                "restoration disabled", self.model_path,
            )
            return False
        self._vocab = vocab
        self._runner = compiled_runner(model, device=self.device,
                                       matmul_precision="highest")
        self._pad_checked = False
        self._output_names = list(model.outputs)
        return True

    # -- inference ---------------------------------------------------------

    def _feeds(self, ids: List[int], pad_to: int) -> Dict[str, np.ndarray]:
        arr = np.full((1, pad_to), self._vocab.get("[PAD]", 0), np.int64)
        arr[0, :len(ids)] = ids
        mask = np.zeros((1, pad_to), np.int64)
        mask[0, :len(ids)] = 1
        return {"input_ids": arr, "attention_mask": mask}

    def _execute(self, ids: List[int]) -> List[np.ndarray]:
        """The model on its runner with bucket-padded lengths (sound
        because BERT-style models mask attention by the
        ``attention_mask`` input — self-checked once against an
        exact-length run on the same runner and device; on mismatch every
        later call runs exact lengths on that runner)."""
        from phoonnx_tpu_torch.onnx.aux_compile import bucket_len

        n = len(ids)
        pad_to = bucket_len(n) if self._pad_ok else n

        def trim(o):
            o = np.asarray(o)
            return (o[:, :n] if o.ndim >= 2 and o.shape[1] == pad_to
                    else o)

        outs = [trim(o) for o in self._runner.run(self._feeds(ids, pad_to))]
        if self._pad_checked or pad_to == n:
            return outs
        self._pad_checked = True
        exact = self._runner.run(self._feeds(ids, n))
        ok = all(np.allclose(a, b, rtol=1e-3, atol=1e-3)
                 for a, b in zip(outs, exact)
                 if np.issubdtype(np.asarray(a).dtype, np.floating))
        if ok:
            return outs
        LOG.warning(
            "phonikud model output changes under length padding "
            "(attention_mask not honored?) — disabling the compiled "
            "bucketed path for this session")
        self._pad_ok = False
        return [np.asarray(o) for o in exact]

    def _run(self, plain: str):
        ids = [self._vocab.get("[CLS]", 2)]
        unk = self._vocab.get("[UNK]", 1)
        ids += [self._vocab.get(ch, unk) for ch in plain]
        ids.append(self._vocab.get("[SEP]", 3))
        outs = self._execute(ids)
        by_name = dict(zip(self._output_names, outs))
        nikud = np.asarray(by_name.get("nikud_logits", outs[0]),
                           np.float32)[0]
        shin = np.asarray(by_name.get("shin_logits", outs[1]),
                          np.float32)[0]
        add = by_name.get("additional_logits",
                          outs[2] if len(outs) > 2 else None)
        add = None if add is None else np.asarray(add, np.float32)[0]
        return nikud, shin, add

    def _diacritize_chunk(self, text: str) -> str:
        plain = strip_nikud(text)
        if not any(_is_hebrew_letter(ch) for ch in plain):
            return text
        nikud_logits, shin_logits, add_logits = self._run(plain)
        out = []
        for i, ch in enumerate(plain):
            if not _is_hebrew_letter(ch):
                out.append(ch)
                continue
            pos = i + 1  # CLS offset
            pieces = [ch]
            if ch == "ש":  # shin needs its dot before the point
                pieces.append(SHIN_CLASSES[int(np.argmax(shin_logits[pos]))])
            marks = NIKUD_CLASSES[int(np.argmax(nikud_logits[pos]))]
            if marks != MAT_LECT_TOKEN:
                pieces.append(marks)
            if add_logits is not None:
                hatama, vocal_shva, prefix = add_logits[pos][:3]
                if hatama > 0:
                    pieces.append(HATAMA)
                if vocal_shva > 0:
                    pieces.append(VOCAL_SHVA)
                if prefix > 0:
                    pieces.append(PREFIX_SEP)
            out.append("".join(pieces))
        return "".join(out)

    # -- public API ----------------------------------------------------------

    def diacritize(self, text: str) -> str:
        if not text or not self._load():
            return text
        out = []
        # chunk on line boundaries; hard-split monster lines at the
        # position budget (whitespace-preferring) so ids fit the model
        for line in text.splitlines(keepends=True):
            while len(line) > CHAR_LIMIT:
                cut = line.rfind(" ", CHAR_LIMIT // 2, CHAR_LIMIT)
                cut = cut if cut > 0 else CHAR_LIMIT
                out.append(self._diacritize_chunk(line[:cut]))
                line = line[cut:]
            out.append(self._diacritize_chunk(line))
        return "".join(out)

    # reference wrapper API name (phonikud_onnx.Phonikud.add_diacritics)
    add_diacritics = diacritize
