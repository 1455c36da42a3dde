"""Voice-conversion CLI: re-speak a WAV in another speaker's voice.

PyTorch port of ``phoonnx_tpu/convert.py``, with argparse in place of
click. It exposes SynthesizerTrn.voice_conversion (reference
models.py:724-732): posterior-encode the source audio with the source
speaker's embedding, pass the latents through the flow in both
directions, decode with the target speaker. Requires a multi-speaker
voice. Runs on the GPU unless ``--device cpu``.

Usage:
    python -m phoonnx_tpu_torch.convert -m voice.onnx -i in.wav \\
        --from-speaker 0 --to-speaker 3 -o out.wav
"""

import argparse
import logging
import wave

import numpy as np

LOG = logging.getLogger("convert")


def _read_wav(path: str, expect_rate: int) -> np.ndarray:
    with wave.open(path, "rb") as f:
        if f.getframerate() != expect_rate:
            raise SystemExit(
                f"error: input is {f.getframerate()} Hz but the voice "
                f"expects {expect_rate} Hz — resample first")
        if f.getnchannels() != 1 or f.getsampwidth() != 2:
            raise SystemExit("error: input must be mono 16-bit PCM")
        pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return pcm.astype(np.float32) / 32767.0


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m phoonnx_tpu_torch.convert",
        description="Re-speak a WAV in another speaker's voice.")
    parser.add_argument("-m", "--model", required=True,
                        help="Path to model.onnx")
    parser.add_argument("-c", "--config", dest="config_path", default=None)
    parser.add_argument("-i", "--input", dest="input_wav", required=True,
                        help="Source WAV (mono 16-bit at the voice sample "
                        "rate)")
    parser.add_argument("-o", "--output", required=True,
                        help="Output WAV path")
    parser.add_argument("--from-speaker", type=int, required=True)
    parser.add_argument("--to-speaker", type=int, required=True)
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    parser.add_argument("--debug", action="store_true")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    from phoonnx_tpu_torch.voice import AudioChunk, TTSVoice

    voice = TTSVoice.load(args.model, args.config_path, device=args.device)
    n_speakers = voice.config.num_speakers
    for name, sid in (("--from-speaker", args.from_speaker),
                      ("--to-speaker", args.to_speaker)):
        if not 0 <= sid < n_speakers:
            raise SystemExit(
                f"error: {name} {sid} out of range: voice has {n_speakers} "
                f"speakers (0..{n_speakers - 1})")
    audio = _read_wav(args.input_wav, voice.config.sample_rate)
    converted = voice.voice_conversion(audio, args.from_speaker,
                                       args.to_speaker, seed=args.seed)
    pcm = AudioChunk(
        sample_rate=voice.config.sample_rate, sample_width=2,
        sample_channels=1,
        audio_float_array=converted.astype(np.float32),
    ).audio_int16_array
    with wave.open(args.output, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(voice.config.sample_rate)
        f.writeframes(pcm.tobytes())
    LOG.info("wrote %s (%.2fs, speaker %d -> %d)", args.output,
             len(pcm) / voice.config.sample_rate, args.from_speaker,
             args.to_speaker)


if __name__ == "__main__":
    main()
