"""Dataset preprocessing CLI: LJSpeech-style corpus -> training dataset.

PyTorch port of ``phoonnx_tpu/train/preprocess.py`` (reference
phoonnx_train/preprocess.py): reads ``metadata.csv`` (``wav|text`` or
``wav|speaker|text``), fans utterances out to a pool of spawned worker
processes (normalize -> casing -> diacritics -> phonemize, and load +
resample the audio), trims silence and takes the spectrograms on one
torch device in this process, collects the corpus phoneme inventory,
builds the final phoneme id map (special tokens 0-3, the default IPA map
for IPA alphabets, sorted new symbols appended; fine-tune mode reuses a
previous config's map), and writes ``config.json`` + ``dataset.jsonl``.

The outputs are the JAX preprocessor's: the same two files and the cache
files under the same names in the same ``.npy`` layout, so either
package's trainer reads either package's dataset.

The workers do host work only, as the JAX workers, which pin their JAX to
the CPU: a phonemizer's models (ByT5, the diacritizers) run on the CPU
there, and no worker opens a CUDA context. The VAD model and the
spectrograms run here on ``device`` (``"cuda"`` by default, which raises
without a GPU; ``"cpu"`` is the caller's choice). A failure there raises
naming the file, where the JAX worker logs it and drops the utterance.

Usage:
    python -m phoonnx_tpu_torch.train.preprocess -i corpus/ -o out/ \\
        -l en-US --phoneme-type espeak --sample-rate 22050
"""

import argparse
import csv
import dataclasses
import json
import logging
import multiprocessing
import os
import queue as queue_mod
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Set

from phoonnx_tpu_torch.config import Alphabet, PhonemeType, get_phonemizer
from phoonnx_tpu_torch.phoneme_ids import (
    DEFAULT_BLANK_TOKEN,
    DEFAULT_BLANK_WORD_TOKEN,
    DEFAULT_BOS_TOKEN,
    DEFAULT_EOS_TOKEN,
    DEFAULT_IPA_PHONEME_ID_MAP,
    DEFAULT_PAD_TOKEN,
    phonemes_to_ids,
)
from phoonnx_tpu_torch.util import normalize
from phoonnx_tpu_torch.version import __version__

LOG = logging.getLogger("preprocess")

DEFAULT_SPECIAL_PHONEME_ID_MAP: Dict[str, int] = {
    DEFAULT_PAD_TOKEN: 0,
    DEFAULT_BOS_TOKEN: 1,
    DEFAULT_EOS_TOKEN: 2,
    DEFAULT_BLANK_WORD_TOKEN: 3,
}


@dataclass
class Utterance:
    text: str
    audio_path: Path
    speaker: Optional[str] = None
    speaker_id: Optional[int] = None
    phonemes: Optional[List[str]] = None
    phoneme_ids: Optional[List[int]] = None
    audio_norm_path: Optional[Path] = None
    audio_spec_path: Optional[Path] = None

    def asdict(self) -> Dict[str, Any]:
        data = dataclasses.asdict(self)
        return {
            k: str(v) if isinstance(v, Path) else v for k, v in data.items()
        }


def get_text_casing(casing: str) -> Callable[[str], str]:
    return {
        "lower": str.lower,
        "upper": str.upper,
        "casefold": str.casefold,
    }.get(casing, lambda s: s)


def read_ljspeech(input_dir: Path, metadata_name: str = "metadata.csv"
                  ) -> Iterable[Utterance]:
    """``wav_name|text`` or ``wav_name|speaker|text`` rows."""
    metadata_path = input_dir / metadata_name
    wav_dirs = [input_dir / "wav", input_dir / "wavs", input_dir]
    with open(metadata_path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE)
        # column layout is a CORPUS property decided by the first row:
        # per-row detection would let one stray '|' inside a 2-column
        # row's text masquerade as a speaker name and silently flip the
        # whole corpus to multispeaker
        n_cols = None
        for row in reader:
            if len(row) < 2:
                continue
            if n_cols is None:
                n_cols = 3 if len(row) > 2 else 2
            filename = row[0]
            if n_cols == 3:
                speaker = row[1] if len(row) > 2 else None
                text = "|".join(row[2:]) if len(row) > 2 else row[1]
            else:
                speaker = None
                text = "|".join(row[1:])
            if not filename.endswith(".wav"):
                filename += ".wav"
            for wav_dir in wav_dirs:
                candidate = wav_dir / filename
                if candidate.exists():
                    yield Utterance(text=text, audio_path=candidate,
                                    speaker=speaker)
                    break
            else:
                LOG.warning("Missing audio file: %s", filename)


def phonemize_worker(task_queue, result_queue,
                     phonemizer, language: str, casing_name: str,
                     add_diacritics: bool, skip_audio: bool,
                     cache_dir: str, sample_rate: int,
                     n_fft: int = 1024, hop_length: int = 256,
                     win_length: int = 1024) -> None:
    """Host work for each utterance: the phonemes, and the audio loaded
    and resampled unless its cache exists. Puts ``(utt, phoneme set,
    audio)`` on ``result_queue``: ``audio`` is None when the cache exists
    (``utt`` then carries its paths), else the (16 kHz, target-rate)
    arrays for the caller to trim and cache on its device; a failed
    utterance puts ``(None, set(), None)``."""
    from phoonnx_tpu_torch.train.audio import cache_paths, read_for_cache

    # the phonemizer's own models run on the host here (the JAX workers
    # pin their JAX to the CPU, TPU-backed phonemizers like ByT5 included)
    phonemizer.device = "cpu"
    casing = get_text_casing(casing_name)
    while True:
        batch = task_queue.get()
        if batch is None:
            task_queue.task_done()
            break
        for utt in batch:
            try:
                text = casing(normalize(utt.text, language))
                if add_diacritics:
                    text = phonemizer.add_diacritics(text, language)
                utt.phonemes = [
                    p for p in phonemizer.phonemize_to_list(text, language)
                    if p != "\n"
                ]
                if not utt.phonemes:
                    raise RuntimeError(f"Phonemes not found for '{text}'")
                audio = None
                if not skip_audio:
                    norm_path, spec_path = cache_paths(
                        str(utt.audio_path), cache_dir, sample_rate,
                        n_fft, hop_length, win_length)
                    if not (os.path.exists(norm_path)
                            and os.path.exists(spec_path)):
                        audio = read_for_cache(str(utt.audio_path),
                                               sample_rate)
                    utt.audio_norm_path, utt.audio_spec_path = (
                        norm_path, spec_path)
                result_queue.put((utt, set(utt.phonemes), audio))
            except Exception:
                LOG.exception("Failed to process %s", utt.audio_path)
                result_queue.put((None, set(), None))
        task_queue.task_done()


def run_preprocess(
    input_dir: str,
    output_dir: str,
    language: str,
    phoneme_type: str = "espeak",
    alphabet: str = "ipa",
    sample_rate: int = 22050,
    max_workers: Optional[int] = None,
    text_casing: str = "ignore",
    add_diacritics: bool = False,
    skip_audio: bool = False,
    single_speaker: bool = False,
    speaker_id: Optional[int] = None,
    prev_config: Optional[str] = None,
    drop_extra_phonemes: bool = False,
    phonemizer_model: Optional[str] = None,
    dataset_name: Optional[str] = None,
    audio_quality: Optional[str] = None,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    cache_dir: Optional[str] = None,
    device: Optional[str] = "cuda",
) -> None:
    from phoonnx_tpu_torch.infer.engine import resolve_device
    from phoonnx_tpu_torch.train.audio import (SileroVoiceActivityDetector,
                                               write_cache)

    dev = resolve_device(device)
    input_path, output_path = Path(input_dir), Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    cache_dir = Path(cache_dir) if cache_dir else (
        output_path / "cache" / str(sample_rate)
    )
    cache_dir.mkdir(parents=True, exist_ok=True)

    utterances = list(read_ljspeech(input_path))
    if not utterances:
        raise ValueError(f"no utterances found in {input_dir}")
    LOG.info("Found %d utterances", len(utterances))

    # Speaker ids by descending utterance count (preprocess.py:452-459)
    is_multispeaker = not single_speaker and any(
        u.speaker for u in utterances
    )
    speaker_ids: Dict[str, int] = {}
    if is_multispeaker:
        counts: Dict[str, int] = {}
        for utt in utterances:
            counts[utt.speaker or ""] = counts.get(utt.speaker or "", 0) + 1
        for idx, name in enumerate(
            sorted(counts, key=counts.get, reverse=True)
        ):
            speaker_ids[name] = idx

    phonemizer = get_phonemizer(
        PhonemeType(phoneme_type), Alphabet(alphabet), phonemizer_model
    )
    # built before any worker starts: a VAD model that cannot be built
    # on the device raises here
    detector = None if skip_audio else SileroVoiceActivityDetector(
        device=dev)

    max_workers = max_workers or max(1, (os.cpu_count() or 2) - 1)
    # spawn (not fork): a child forked from a parent holding a CUDA
    # context cannot use it, and the workers need none
    ctx = multiprocessing.get_context("spawn")
    task_queue = ctx.JoinableQueue()
    result_queue = ctx.Queue()
    workers = [
        ctx.Process(
            target=phonemize_worker,
            args=(task_queue, result_queue, phonemizer, language,
                  text_casing, add_diacritics, skip_audio, str(cache_dir),
                  sample_rate, n_fft, hop_length, win_length),
            daemon=True,
        )
        for _ in range(max_workers)
    ]
    for worker in workers:
        worker.start()

    try:
        batch_size = max(1, len(utterances) // (max_workers * 2))
        for start in range(0, len(utterances), batch_size):
            task_queue.put(utterances[start:start + batch_size])
        for _ in workers:
            task_queue.put(None)

        processed: List[Utterance] = []
        all_phonemes: Set[str] = set()
        pending = len(utterances)
        while pending > 0:
            try:
                utt, phoneme_set, audio = result_queue.get(timeout=30.0)
            except queue_mod.Empty:
                # per-utterance errors yield sentinels, so a long silence
                # means a worker died without one (OOM kill, native-library
                # segfault). Don't await its results forever.
                dead = [w for w in workers if not w.is_alive()
                        and w.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} preprocess worker(s) died "
                        f"(exitcodes {[w.exitcode for w in dead]}) — "
                        f"{pending} utterances unaccounted for"
                    )
                continue
            pending -= 1
            if utt is None:
                continue
            if audio is not None:
                try:
                    write_cache(*audio, str(utt.audio_norm_path),
                                str(utt.audio_spec_path), sample_rate,
                                n_fft, hop_length, win_length, detector,
                                dev)
                except Exception as exc:
                    raise RuntimeError(
                        f"trimming and caching {utt.audio_path} on {dev} "
                        "failed") from exc
            processed.append(utt)
            all_phonemes.update(phoneme_set)
        task_queue.join()
    finally:
        for worker in workers:
            if worker.is_alive():
                worker.terminate()
            worker.join()
    LOG.info("Processed %d utterances", len(processed))
    # the workers finish in any order; keep the corpus's
    order = {str(u.audio_path): i for i, u in enumerate(utterances)}
    processed.sort(key=lambda u: order[str(u.audio_path)])

    # --- phoneme id map (preprocess.py:515-556) ---
    if prev_config:
        with open(prev_config, encoding="utf-8") as f:
            final_map: Dict[str, int] = json.load(f)["phoneme_id_map"]
        all_phonemes.update(final_map.keys())
    else:
        final_map = dict(DEFAULT_SPECIAL_PHONEME_ID_MAP)
        if phonemizer.alphabet == Alphabet.IPA:
            final_map.update(
                {k: v[0] for k, v in DEFAULT_IPA_PHONEME_ID_MAP.items()}
            )

    new_phonemes = sorted(p for p in all_phonemes if p not in final_map)
    finetune_error = prev_config and new_phonemes
    if finetune_error and not drop_extra_phonemes:
        raise ValueError(
            "training data contains different phonemes than previous "
            "phoneme map! Can not finetune model"
        )
    if not finetune_error:
        next_id = len(final_map)
        for phoneme in new_phonemes:
            final_map[phoneme] = next_id
            next_id += 1

    # --- config.json (same keys as preprocess.py:563-585) ---
    config_data = {
        "dataset": dataset_name or output_path.parent.name,
        "audio": {
            "sample_rate": sample_rate,
            "quality": audio_quality or output_path.name,
        },
        "lang_code": language,
        "inference": {"noise_scale": 0.667, "length_scale": 1,
                      "noise_w": 0.8, "add_diacritics": add_diacritics},
        "alphabet": phonemizer.alphabet.value,
        "phoneme_type": phoneme_type,
        "phonemizer_model": phonemizer_model,
        "phoneme_id_map": final_map,
        "num_symbols": len(final_map),
        "num_speakers": len(speaker_ids) if is_multispeaker else 1,
        "speaker_id_map": speaker_ids,
        "phoonnx_version": __version__,
        # Explicit tokenization specials: dataset.jsonl ids are built with
        # the defaults below, and VoiceConfig.from_dict reads these keys —
        # writing them pins inference tokenization to training even for
        # non-espeak phonemizers (the reference omits them, which makes it
        # load its own non-espeak voices with token=None and silently drop
        # bos/eos/blank at inference).
        "pad": DEFAULT_PAD_TOKEN,
        "blank": DEFAULT_BLANK_TOKEN,
        "bos": DEFAULT_BOS_TOKEN,
        "eos": DEFAULT_EOS_TOKEN,
    }
    with open(output_path / "config.json", "w", encoding="utf-8") as f:
        json.dump(config_data, f, ensure_ascii=False, indent=2)

    # --- dataset.jsonl ---
    written = 0
    with open(output_path / "dataset.jsonl", "w", encoding="utf-8") as f:
        for utt in processed:
            if is_multispeaker:
                # speakerless rows in a multispeaker corpus were counted
                # under '' — assign that id instead of leaving
                # speaker_id null (collate would default null to 0,
                # silently attributing them to the most-frequent speaker)
                name = utt.speaker or ""
                if name not in speaker_ids:
                    LOG.error("Speaker '%s' not in speaker_id_map", name)
                    continue
                utt.speaker_id = speaker_ids[name]
            elif speaker_id is not None:
                utt.speaker_id = speaker_id
            if utt.phonemes:
                if not any(p in final_map for p in utt.phonemes):
                    # every symbol dropped (e.g. --drop-extra-phonemes
                    # against a diverged phonemizer): the id sequence
                    # would be specials-only — full-length audio paired
                    # with no linguistic content
                    LOG.warning(
                        "Skipping utterance with no mappable phonemes: "
                        "%s", utt.audio_path)
                    continue
                utt.phoneme_ids = phonemes_to_ids(
                    utt.phonemes, id_map=final_map
                )
            if not utt.phoneme_ids:
                LOG.warning("Skipping utterance with no phoneme_ids: %s",
                            utt.audio_path)
                continue
            json.dump(utt.asdict(), f, ensure_ascii=False)
            f.write("\n")
            written += 1
    LOG.info("Wrote %d utterances to dataset.jsonl", written)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Preprocess an LJSpeech-style corpus into a training "
                    "dataset with phoonnx_tpu_torch.")
    parser.add_argument("-i", "--input-dir", required=True)
    parser.add_argument("-o", "--output-dir", required=True)
    parser.add_argument("-l", "--language", required=True)
    parser.add_argument("--phoneme-type", default="espeak")
    parser.add_argument("--alphabet", default="ipa")
    parser.add_argument("--sample-rate", default=22050, type=int)
    parser.add_argument("--max-workers", default=None, type=int)
    parser.add_argument("--text-casing", default="ignore",
                        choices=["ignore", "lower", "upper", "casefold"])
    parser.add_argument("--add-diacritics", action="store_true")
    parser.add_argument("--skip-audio", action="store_true")
    parser.add_argument("--single-speaker", action="store_true")
    parser.add_argument("--speaker-id", default=None, type=int)
    parser.add_argument("--prev-config", default=None)
    parser.add_argument("--drop-extra-phonemes", action="store_true")
    parser.add_argument("--phonemizer-model", default=None)
    parser.add_argument("--dataset-name", default=None)
    parser.add_argument("--audio-quality", default=None)
    parser.add_argument("--cache-dir", default=None,
                        help="Audio cache directory (default: "
                             "<output-dir>/cache/<sample-rate>)")
    parser.add_argument("--n-fft", default=1024, type=int)
    parser.add_argument("--hop-length", default=256, type=int)
    parser.add_argument("--win-length", default=1024, type=int)
    parser.add_argument("--vad-model", default=None,
                        help="Silero-VAD ONNX model for silence trimming "
                             "(default: $PHOONNX_VAD_MODEL, the package data "
                             "dir, or ~/.local/share/phoonnx/silero_vad.onnx; "
                             "energy VAD when none found)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the VAD model and the "
                             "spectrograms; 'cpu' runs them on the host")
    parser.add_argument("--debug", action="store_true")
    args = vars(parser.parse_args(argv))
    debug = args.pop("debug")
    vad_model = args.pop("vad_model")
    if vad_model:
        # the detector resolves its model through the environment, as
        # the JAX package's spawned workers do
        os.environ["PHOONNX_VAD_MODEL"] = vad_model
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)
    run_preprocess(**args)


if __name__ == "__main__":
    main()
