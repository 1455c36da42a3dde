"""Quantize an existing voice to int8 (weight-only).

PyTorch port of ``phoonnx_tpu/quantize.py``. Re-packs any importable VITS
voice — fp32 or already quantized — as an int8 QDQ executable graph ~4x
smaller on disk: the weights are imported through the standard
name-routing path (onnx/dequant folds existing quantization triples
first), then re-exported with ``export_vits_onnx(quantize=True)``. The
result runs under onnxruntime (the reference's engine, voice.py:167),
under the port's graph runner and the JAX package's interpreter, and
reloads onto the native engine (kernels A, B and C on the card) via the
dequantizing importer. Quantizing is a file conversion on the host.

The reference has no quantization tooling — its users run onnxruntime's
``quantize_dynamic`` externally; this is the in-framework equivalent.

Usage:
    python -m phoonnx_tpu_torch.quantize -m voice.onnx -o voice.int8.onnx
"""

import argparse
import logging
import shutil
import sys
from pathlib import Path

import numpy as np

LOG = logging.getLogger("quantize")


def quantize_voice(model_path: str, output_path: str,
                   config_path: str = None) -> None:
    """Write ``output_path`` (and its ``.json`` config beside it); raises
    ValueError for a voice whose weights do not import by name."""
    from phoonnx_tpu_torch.models.vits.load import (
        infer_hparams_from_flat,
        params_from_flat,
        params_to_flat,
        routed_fraction,
    )
    from phoonnx_tpu_torch.onnx.dequant import dequantize_flat
    from phoonnx_tpu_torch.onnx.reader import read_onnx
    from phoonnx_tpu_torch.onnx.vits_graph import export_vits_onnx

    model = read_onnx(model_path)
    named, n_deq = dequantize_flat(model.initializers)
    if n_deq:
        LOG.info("input already carried %d quantized tensors "
                 "(re-quantizing from the dequantized weights)", n_deq)
    unresolved = [k for k in named if k.endswith("_quantized")]
    if unresolved:
        # same guard TTSVoice.load applies: an ambiguous per-channel
        # triple (square weights) cannot be dequantized by name, and a
        # partial import would re-export those layers from RANDOM
        # initialization — a voice that synthesizes noise with no error
        raise ValueError(
            f"{len(unresolved)} quantized tensors could not be resolved "
            f"by name (first: {unresolved[0]!r}); this voice cannot be "
            "re-quantized — it runs via its own graph as-is"
        )
    if routed_fraction(named) < 0.25:
        raise ValueError(
            "this voice's weights do not match the VITS import layout — "
            "only importable (piper/phoonnx-style) voices can be "
            "re-quantized; foreign graphs run via the graph engine as-is"
        )

    overrides = {}
    if "sample_rate" in model.metadata:
        overrides["sample_rate"] = int(model.metadata["sample_rate"])
    for key in ("istft_hop", "istft_n_fft", "istft_bands"):
        if key in model.metadata:
            overrides[key] = int(model.metadata[key])
    hp = infer_hparams_from_flat(named, **overrides)
    params = params_from_flat(named, hp, strict=False)
    flat = {k: np.asarray(v) for k, v in params_to_flat(params).items()}

    metadata = dict(model.metadata)
    export_vits_onnx(flat, hp, output_path, metadata=metadata,
                     quantize=True)

    in_size = Path(model_path).stat().st_size
    out_size = Path(output_path).stat().st_size
    LOG.info("wrote %s (%.1f MB -> %.1f MB)", output_path,
             in_size / 1e6, out_size / 1e6)

    src_config = Path(config_path) if config_path else Path(
        str(model_path) + ".json")
    dst_config = Path(str(output_path) + ".json")
    if src_config.exists() and src_config.resolve() != dst_config.resolve():
        shutil.copyfile(src_config, dst_config)
        LOG.info("copied config to %s", dst_config)
    elif not src_config.exists():
        LOG.warning("no config.json found next to the input model; "
                    "place one next to the output for TTSVoice.load")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Quantize a VITS voice to int8 weights (QDQ graph).")
    parser.add_argument("-m", "--model", required=True,
                        help="Path to model.onnx")
    parser.add_argument("-c", "--config", dest="config_path", default=None,
                        help="config.json to copy (default: <model>.json)")
    parser.add_argument("-o", "--output", required=True,
                        help="Output int8 model path")
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    try:
        quantize_voice(args.model, args.output, args.config_path)
    except Exception as exc:  # surface import errors as clean CLI errors
        LOG.debug("quantize failed", exc_info=True)
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
