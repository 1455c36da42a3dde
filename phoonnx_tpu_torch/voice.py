"""Public inference API: TTSVoice / AudioChunk / PhoneticSpellings.

PyTorch port of ``phoonnx_tpu/voice.py``, mirroring the reference surface
(phoonnx/voice.py): ``TTSVoice.load`` accepts the same ``model.onnx`` +
``config.json`` voices, ``synthesize`` yields one :class:`AudioChunk` per
sentence, ``synthesize_wav`` streams into a wave writer. The onnxruntime
session is replaced by :class:`phoonnx_tpu_torch.infer.VitsEngine`, which
runs on the GPU unless the caller passes ``device="cpu"``; a voice whose
weights do not import by name runs its own ONNX graph on the same device
(:class:`phoonnx_tpu_torch.infer.onnx_engine.OnnxFallbackEngine`).

Documented divergence: the reference's ``phonemize`` duplicates every
sentence via ``phonemes.extend(phonemes)`` (voice.py:206) and loses raw
``[[...]]`` blocks by rebinding; this implementation does what that code
clearly intends (accumulate sentences, preserve inline phoneme blocks).
"""

import json
import logging
import os
import re
import wave
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

from phoonnx_tpu_torch.config import (
    SynthesisConfig,
    VoiceConfig,
    get_phonemizer,
)
from phoonnx_tpu_torch.langtags import closest_match
# BlankBetween/Phonemizer are importable from here for parity with the
# reference's voice.py namespace (reference voice.py imports both)
from phoonnx_tpu_torch.phoneme_ids import BlankBetween, phonemes_to_ids  # noqa: F401
from phoonnx_tpu_torch.phonemizers import Phonemizer  # noqa: F401
from phoonnx_tpu_torch.phonemizers.base import PhonemizedChunks

LOG = logging.getLogger(__name__)

_PHONEME_BLOCK_PATTERN = re.compile(r"(\[\[.*?\]\])")
_LOCALE_PATH = os.path.join(os.path.dirname(__file__), "locale")


@dataclass
class PhoneticSpellings:
    """Per-language word -> spelling overrides (voice.py:29-58)."""

    replacements: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def from_lang(lang: str, locale_path: str = _LOCALE_PATH
                  ) -> "PhoneticSpellings":
        langs = os.listdir(locale_path)
        best, distance = closest_match(lang, langs)
        if distance <= 10:
            return PhoneticSpellings.from_path(
                os.path.join(locale_path, best, "phonetic_spellings.txt")
            )
        raise FileNotFoundError(f"Spellings file for '{lang}' not found")

    @staticmethod
    def from_path(spellings_file: str) -> "PhoneticSpellings":
        replacements = {}
        with open(spellings_file, encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if ":" not in line:
                    continue
                word, spelling = line.split(":", 1)
                replacements[word.strip()] = spelling.strip()
        return PhoneticSpellings(replacements)

    def apply(self, text: str) -> str:
        for word, spelling in self.replacements.items():
            pattern = r"\b" + re.escape(word) + r"\b"
            text = re.sub(pattern, spelling, text, flags=re.IGNORECASE)
        return text


@dataclass
class AudioChunk:
    """Raw audio chunk: float32 [-1, 1] + lazy int16 (voice.py:61-102)."""

    sample_rate: int
    sample_width: int
    sample_channels: int
    audio_float_array: np.ndarray

    _audio_int16_array: Optional[np.ndarray] = None
    _MAX_WAV_VALUE: float = 32767.0

    @property
    def audio_int16_array(self) -> np.ndarray:
        if self._audio_int16_array is None:
            self._audio_int16_array = np.clip(
                self.audio_float_array * self._MAX_WAV_VALUE,
                -self._MAX_WAV_VALUE, self._MAX_WAV_VALUE,
            ).astype(np.int16)
        return self._audio_int16_array

    @property
    def audio_int16_bytes(self) -> bytes:
        return self.audio_int16_array.tobytes()


@dataclass
class TTSVoice:
    """A loaded voice: synthesis engine + linguistic front-end."""

    engine: "VitsEngine"
    config: VoiceConfig
    phonetic_spellings: Optional[PhoneticSpellings] = None
    phonemizer: Optional["Phonemizer"] = None

    def __post_init__(self):
        if self.phonetic_spellings is None:
            try:
                self.phonetic_spellings = PhoneticSpellings.from_lang(
                    self.config.lang_code
                )
            except (FileNotFoundError, OSError):
                pass
        if self.phonemizer is None:
            self.phonemizer = get_phonemizer(
                self.config.phoneme_type,
                self.config.alphabet,
                self.config.phonemizer_model,
            )

    # ------------------------------------------------------------------
    # Loading
    # ------------------------------------------------------------------

    @staticmethod
    def load(
        model_path: Union[str, Path],
        config_path: Optional[Union[str, Path]] = None,
        phonemes_txt: Optional[str] = None,
        phoneme_map: Optional[str] = None,
        lang_code: Optional[str] = None,
        phoneme_type_str: Optional[str] = None,
        dtype: str = "float32",
        device=None,
        matmul_precision: Optional[str] = None,
    ) -> "TTSVoice":
        """Load an ONNX voice (reference recipe) onto the engine.

        The .onnx file provides the weights (initializers keep the trainer's
        state_dict names, export_onnx.py:318-327); config.json provides the
        front-end settings. Weights import by name into the parameter tree.

        device: None means the GPU, and raises RuntimeError when there is
        none; ``"cpu"`` runs the plain PyTorch path. The phonemizer's
        models (the ByT5/Charsiu G2P, the tashkeel and phonikud
        diacritizers) run on the same device. ``dtype``:
        ``"float32"`` or ``"bfloat16"`` (every floating weight cast, the
        kernels' bf16 builds, as the JAX package serves);
        ``matmul_precision``: ``None``/``"default"``, ``"high"`` or
        ``"highest"`` (:class:`VitsEngine`).

        A voice whose weights do not import by name (unresolved int8
        tensors, a foreign layout such as coqui-VITS or mimic3, or
        hyperparameters that cannot be inferred) runs its own ONNX graph
        on ``device`` through
        :class:`~phoonnx_tpu_torch.infer.onnx_engine.OnnxFallbackEngine`,
        with a warning, as in the JAX package. ``dtype`` and
        ``matmul_precision`` do not reach that engine: the graph runs in
        its own dtypes, with TF32 off.
        """
        from phoonnx_tpu_torch.infer.engine import VitsEngine, resolve_device
        from phoonnx_tpu_torch.models.vits.load import (
            infer_hparams_from_flat,
            params_from_flat,
            recover_anonymous_weights,
            routed_fraction,
        )
        from phoonnx_tpu_torch.onnx.dequant import dequantize_flat
        from phoonnx_tpu_torch.onnx.reader import read_onnx

        # fail on a missing GPU before any file work
        device = resolve_device(device)
        if config_path is None:
            config_path = f"{model_path}.json"
            LOG.debug("Guessing voice config path: %s", config_path)

        with open(config_path, "r", encoding="utf-8") as config_file:
            config_dict = json.load(config_file)

        config = VoiceConfig.from_dict(
            config_dict, phonemes_txt=phonemes_txt, lang_code=lang_code,
            phoneme_type_str=phoneme_type_str,
        )

        onnx_model = read_onnx(str(model_path))
        # torch.onnx.export's constant folding erases the state-dict
        # names of weight-normed convs; recover them from the consuming
        # nodes so real reference exports import losslessly by name
        named = recover_anonymous_weights(onnx_model)
        # int8-quantized exports keep the state-dict names as
        # X_quantized/X_scale/X_zero_point triples: fold them back
        named, n_deq = dequantize_flat(named)
        if n_deq:
            LOG.info("dequantized %d int8 weight tensors for import",
                     n_deq)
        overrides = {"sample_rate": config.sample_rate}
        for key in ("istft_hop", "istft_n_fft", "istft_bands"):
            if key in onnx_model.metadata:
                overrides[key] = int(onnx_model.metadata[key])
        try:
            unresolved = [k for k in named if k.endswith("_quantized")]
            if unresolved:
                # e.g. ambiguous per-channel axes (square weights): a
                # partial import would silently leave those leaves
                # random — run the voice's own graph instead, where the
                # node attributes carry the exact dequantization axes
                raise ValueError(
                    f"{len(unresolved)} quantized tensors could not be "
                    f"resolved by name (first: {unresolved[0]!r})")
            if routed_fraction(named) < 0.25:
                raise ValueError(
                    "initializer names do not match the VITS import layout")
            hp = infer_hparams_from_flat(named, **overrides)
            params = params_from_flat(named, hp, strict=False)
        except (KeyError, ValueError) as exc:
            # Not the piper/phoonnx VITS weight layout (e.g. a coqui-VITS
            # or mimic3 export): run the voice's own ONNX graph, op by op
            # on the device (onnx/torch_lowering.py)
            from phoonnx_tpu_torch.infer.onnx_engine import (
                OnnxFallbackEngine,
            )

            LOG.warning(
                "weights do not match the VITS import layout (%s); "
                "falling back to running the voice's own ONNX graph on %s "
                "(a voice in the piper/phoonnx layout runs on the native "
                "engine)", exc, device)
            engine = OnnxFallbackEngine(onnx_model, config.sample_rate,
                                        device=device)
        else:
            # the weights imported: from here on, errors are genuine
            engine = VitsEngine(params, hp, dtype=dtype, device=device,
                                matmul_precision=matmul_precision)
        voice = TTSVoice(engine=engine, config=config)
        # the front end's models (G2P, diacritizers) run on the voice's
        # device; the phonemizer builds them lazily, after this
        voice.phonemizer.device = device
        return voice

    # ------------------------------------------------------------------
    # Front-end
    # ------------------------------------------------------------------

    def phonemize(self, text: str) -> PhonemizedChunks:
        """Text to per-sentence phoneme lists, honoring inline ``[[...]]``
        raw phoneme blocks (voice.py:174-212)."""
        phonemes: PhonemizedChunks = []
        text_parts = _PHONEME_BLOCK_PATTERN.split(text)

        for i, part in enumerate(text_parts):
            if part.startswith("[["):
                if not phonemes:
                    phonemes.append([])
                if i > 0 and text_parts[i - 1].endswith(" "):
                    phonemes[-1].append(" ")
                phonemes[-1].extend(list(part[2:-2].strip()))
                if i < len(text_parts) - 1 and text_parts[i + 1].startswith(" "):
                    phonemes[-1].append(" ")
                continue
            if not part.strip():
                continue
            phonemes.extend(
                self.phonemizer.phonemize(part, self.config.lang_code)
            )

        if phonemes and not phonemes[-1]:
            phonemes.pop()
        return phonemes

    def phonemes_to_ids(self, phonemes: List[str]) -> List[int]:
        if self.config.phoneme_id_map is None:
            raise ValueError("voice config has no phoneme_id_map")
        # the parsed blank_between is honored here (mimic3 voices declare
        # e.g. "words"); the reference parses it too but then hardcodes
        # TOKENS_AND_WORDS at synthesis (voice.py:231), mis-tokenizing
        # such voices — a bug, not a behavior to replicate
        return phonemes_to_ids(
            phonemes, self.config.phoneme_id_map,
            blank_token=self.config.blank_token,
            bos_token=self.config.bos_token,
            eos_token=self.config.eos_token,
            word_sep_token=self.config.word_sep_token,
            include_whitespace=self.config.include_whitespace,
            blank_at_start=self.config.blank_at_start,
            blank_at_end=self.config.blank_at_end,
            blank_between=self.config.blank_between,
        )

    # ------------------------------------------------------------------
    # Synthesis
    # ------------------------------------------------------------------

    def synthesize(
        self, text: str, syn_config: Optional[SynthesisConfig] = None,
    ) -> Iterable[AudioChunk]:
        """Yield one audio chunk per sentence (voice.py:234-289)."""
        if syn_config is None:
            syn_config = SynthesisConfig()

        if self.phonetic_spellings and syn_config.enable_phonetic_spellings:
            text = self.phonetic_spellings.apply(text)

        if syn_config.add_diacritics:
            text = self.phonemizer.add_diacritics(text, self.config.lang_code)

        sentence_phonemes = self.phonemize(text)
        LOG.debug("phonemes=%s", sentence_phonemes)

        for phonemes in sentence_phonemes:
            if not phonemes:
                continue
            phoneme_ids = self.phonemes_to_ids(phonemes)
            if not phoneme_ids:
                continue

            audio = self.phoneme_ids_to_audio(phoneme_ids, syn_config)

            if syn_config.normalize_audio:
                max_val = np.max(np.abs(audio))
                audio = (np.zeros_like(audio) if max_val < 1e-8
                         else audio / max_val)
            if syn_config.volume != 1.0:
                audio = audio * syn_config.volume
            audio = np.clip(audio, -1.0, 1.0).astype(np.float32)

            yield AudioChunk(
                sample_rate=self.config.sample_rate,
                sample_width=2,
                sample_channels=1,
                audio_float_array=audio,
            )

    def synthesize_streaming(
        self, text: str, syn_config: Optional[SynthesisConfig] = None,
        chunk_frames: int = 128, overlap_frames: int = 32,
        engine=None,
    ) -> Iterable[AudioChunk]:
        """Yield audio in sub-sentence chunks as the decoder produces them.

        Each sentence's decoder runs ``chunk_frames`` latent frames at a
        time (``VitsEngine.synthesize_ids_streaming``), so the first audio
        comes before the sentence is decoded. The concatenated stream
        equals :meth:`synthesize` for the same seed. ``engine`` may name
        another engine of the same voice. ``normalize_audio`` is ignored:
        the utterance's peak is unknown until its last chunk.
        """
        if syn_config is None:
            syn_config = SynthesisConfig()

        if self.phonetic_spellings and syn_config.enable_phonetic_spellings:
            text = self.phonetic_spellings.apply(text)
        if syn_config.add_diacritics:
            text = self.phonemizer.add_diacritics(text, self.config.lang_code)

        noise_scale, length_scale, noise_w = self._resolve_scales(
            syn_config)

        for phonemes in self.phonemize(text):
            if not phonemes:
                continue
            phoneme_ids = self.phonemes_to_ids(phonemes)
            if not phoneme_ids:
                continue
            for audio in (engine or self.engine).synthesize_ids_streaming(
                phoneme_ids,
                chunk_frames=chunk_frames,
                overlap_frames=overlap_frames,
                noise_scale=noise_scale,
                length_scale=length_scale,
                noise_w=noise_w,
                speaker_id=syn_config.speaker_id or 0,
                seed=syn_config.seed,
                lang_id=syn_config.lang_id or 0,
            ):
                if syn_config.volume != 1.0:
                    audio = audio * syn_config.volume
                audio = np.clip(audio, -1.0, 1.0).astype(np.float32)
                yield AudioChunk(
                    sample_rate=self.config.sample_rate,
                    sample_width=2,
                    sample_channels=1,
                    audio_float_array=audio,
                )

    def synthesize_wav(
        self,
        text: str,
        wav_file: wave.Wave_write,
        syn_config: Optional[SynthesisConfig] = None,
        set_wav_format: bool = True,
        sentence_silence: float = 0.0,
    ) -> None:
        """Synthesize text into an open wave writer (voice.py:291-326).

        sentence_silence: seconds of silence between sentences (the
        reference hardcodes 0.0)."""
        silence_bytes = bytes(
            int(self.config.sample_rate * sentence_silence * 2)
        )
        if set_wav_format:
            # upfront, not from the first chunk: zero-chunk inputs would
            # otherwise crash Wave_write.close() with "# channels not
            # specified" and leave a corrupt file
            wav_file.setframerate(self.config.sample_rate)
            wav_file.setsampwidth(2)
            wav_file.setnchannels(1)
        first_chunk = True
        for chunk in self.synthesize(text, syn_config=syn_config):
            if not first_chunk:
                wav_file.writeframes(silence_bytes)
            first_chunk = False
            wav_file.writeframes(chunk.audio_int16_bytes)

    def synthesize_batch(
        self,
        texts: List[str],
        syn_config: Optional[SynthesisConfig] = None,
    ) -> List[np.ndarray]:
        """Batched multi-utterance synthesis (one waveform per text).

        All sentences across all texts are phonemized, padded to the
        longest, and decoded together.
        """
        if syn_config is None:
            syn_config = SynthesisConfig()

        per_text_ids: List[List[List[int]]] = []
        flat_ids: List[List[int]] = []
        for text in texts:
            if self.phonetic_spellings and \
                    syn_config.enable_phonetic_spellings:
                text = self.phonetic_spellings.apply(text)
            if syn_config.add_diacritics:
                text = self.phonemizer.add_diacritics(
                    text, self.config.lang_code
                )
            sentence_ids = [
                self.phonemes_to_ids(ph)
                for ph in self.phonemize(text) if ph
            ]
            sentence_ids = [ids for ids in sentence_ids if ids]
            per_text_ids.append(sentence_ids)
            flat_ids.extend(sentence_ids)

        if not flat_ids:
            return [np.zeros(0, np.float32) for _ in texts]

        noise_scale, length_scale, noise_w = self._resolve_scales(
            syn_config)
        audio, frame_lengths = self.engine.synthesize_batch(
            flat_ids,
            noise_scale=noise_scale,
            length_scale=length_scale,
            noise_w=noise_w,
            speaker_ids=[syn_config.speaker_id or 0] * len(flat_ids),
            seed=syn_config.seed,
            lang_id=syn_config.lang_id or 0,
        )
        upsample = self.engine.hp.total_upsample

        outputs: List[np.ndarray] = []
        cursor = 0
        for sentence_ids in per_text_ids:
            pieces = []
            for _ in sentence_ids:
                n = frame_lengths[cursor] * upsample
                pieces.append(audio[cursor][:n])
                cursor += 1
            wav = (np.concatenate(pieces) if pieces
                   else np.zeros(0, np.float32))
            if syn_config.normalize_audio and len(wav):
                peak = np.max(np.abs(wav))
                wav = wav / peak if peak > 1e-8 else np.zeros_like(wav)
            if syn_config.volume != 1.0:
                wav = wav * syn_config.volume
            outputs.append(np.clip(wav, -1.0, 1.0).astype(np.float32))
        return outputs

    def voice_conversion(self, audio: np.ndarray, sid_src: int,
                         sid_tgt: int, seed: Optional[int] = None
                         ) -> np.ndarray:
        """Re-speak a waveform in another speaker's voice
        (models.py:724-732; multi-speaker voices only)."""
        return self.engine.voice_conversion(audio, sid_src, sid_tgt,
                                            seed=seed)

    def _resolve_scales(self, syn_config: SynthesisConfig):
        """(noise_scale, length_scale, noise_w): per-call override if set,
        else the voice config's default (one source of truth — this
        defaulting used to be copy-pasted per synthesis method)."""
        cfg = self.config
        return (
            float(syn_config.noise_scale if syn_config.noise_scale
                  is not None else cfg.noise_scale),
            float(syn_config.length_scale if syn_config.length_scale
                  is not None else cfg.length_scale),
            float(syn_config.noise_w_scale if syn_config.noise_w_scale
                  is not None else cfg.noise_w_scale),
        )

    def phoneme_ids_to_audio(
        self, phoneme_ids: List[int],
        syn_config: Optional[SynthesisConfig] = None,
    ) -> np.ndarray:
        """Run the VITS engine on one id sequence (voice.py:328-379)."""
        if syn_config is None:
            syn_config = SynthesisConfig()

        noise_scale, length_scale, noise_w = self._resolve_scales(
            syn_config)

        return self.engine.synthesize_ids(
            phoneme_ids,
            noise_scale=float(noise_scale),
            length_scale=float(length_scale),
            noise_w=float(noise_w),
            speaker_id=syn_config.speaker_id or 0,
            seed=syn_config.seed,
            lang_id=syn_config.lang_id or 0,
        )
