"""Synthesis CLI: text -> WAV, on the GPU unless ``--device cpu``.

PyTorch port of ``phoonnx_tpu/synthesize.py``, with argparse in place of
click. Usage:
    python -m phoonnx_tpu_torch.synthesize --model voice.onnx \\
        --config voice.json --text "Hello world." --output out.wav
    echo "Hello." | python -m phoonnx_tpu_torch.synthesize -m voice.onnx \\
        -o out.wav

``--bf16`` runs the voice in bfloat16 and ``--precision`` sets the
engine's matmul precision (``high`` allows TF32 in the library products),
as in the JAX CLI. The
JAX CLI's ``--compile-cache`` has no counterpart: the port compiles no
XLA programs (``observability.py``).
"""

import argparse
import logging
import sys
import time
import wave

LOG = logging.getLogger("synthesize")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m phoonnx_tpu_torch.synthesize",
        description="Synthesize text to a WAV file.")
    parser.add_argument("-m", "--model", required=True,
                        help="Path to model.onnx")
    parser.add_argument("-c", "--config", dest="config_path", default=None,
                        help="Path to config.json (default: <model>.json)")
    parser.add_argument("-t", "--text", default=None,
                        help="Text to synthesize (default: stdin)")
    parser.add_argument("-o", "--output", required=True,
                        help="Output WAV path")
    parser.add_argument("--speaker-id", default=None, type=int)
    parser.add_argument("--length-scale", default=None, type=float)
    parser.add_argument("--noise-scale", default=None, type=float)
    parser.add_argument("--noise-w", default=None, type=float)
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--no-normalize", action="store_true")
    parser.add_argument("--volume", default=1.0, type=float)
    parser.add_argument("--bf16", action="store_true",
                        help="Run the model in bfloat16 (every floating "
                        "weight cast, the kernels' bf16 builds)")
    parser.add_argument("--precision", default=None,
                        choices=["default", "high", "highest"],
                        help="Matmul precision: 'high' allows TF32 in "
                        "cuBLAS/cuDNN products; 'default' and 'highest' "
                        "keep them float32")
    parser.add_argument("--stream", action="store_true",
                        help="Write WAV frames incrementally as the vocoder "
                        "produces them (sub-sentence chunked decode; "
                        "implies --no-normalize: the peak is unknown "
                        "upfront)")
    parser.add_argument("--stats", dest="show_stats", action="store_true",
                        help="Print RTF/latency stats to stderr")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    parser.add_argument("--debug", action="store_true")
    return parser


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    from phoonnx_tpu_torch.config import SynthesisConfig
    from phoonnx_tpu_torch.observability import SynthesisStats
    from phoonnx_tpu_torch.voice import TTSVoice

    text = args.text
    if text is None:
        text = sys.stdin.read()

    voice = TTSVoice.load(
        args.model, args.config_path,
        dtype="bfloat16" if args.bf16 else "float32",
        device=args.device,
        matmul_precision=(None if args.precision in (None, "default")
                          else args.precision))
    syn_config = SynthesisConfig(
        speaker_id=args.speaker_id,
        length_scale=args.length_scale,
        noise_scale=args.noise_scale,
        noise_w_scale=args.noise_w,
        seed=args.seed,
        normalize_audio=not args.no_normalize,
        volume=args.volume,
    )

    stats = SynthesisStats()
    start = time.perf_counter()
    with wave.open(args.output, "wb") as wav_file:
        if args.stream:
            # header params are known upfront: a zero-chunk input then
            # still closes into a valid WAV
            wav_file.setframerate(voice.config.sample_rate)
            wav_file.setsampwidth(2)
            wav_file.setnchannels(1)
            first = True
            for chunk in voice.synthesize_streaming(text, syn_config):
                if first:
                    LOG.info("first audio after %.3fs",
                             time.perf_counter() - start)
                    first = False
                wav_file.writeframes(chunk.audio_int16_bytes)
        else:
            voice.synthesize_wav(text, wav_file, syn_config)
    elapsed = time.perf_counter() - start

    with wave.open(args.output, "rb") as wav_file:
        audio_s = wav_file.getnframes() / wav_file.getframerate()
    stats.record(elapsed, audio_s)
    if args.show_stats:
        print(stats.summary(), file=sys.stderr)
    LOG.info("wrote %s (%.2fs audio in %.2fs)", args.output, audio_s,
             elapsed)


if __name__ == "__main__":
    main()
