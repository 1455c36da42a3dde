"""Export CLI: trained checkpoint -> distributable voice.

PyTorch port of ``phoonnx_tpu/train/export.py`` (reference
phoonnx_train/export_onnx.py): writes a ``model.onnx`` container whose
initializers carry the reference state_dict names (so this package, the
JAX package and any name-based importer can load it), with the exporter's
metadata_props (export_onnx.py:335-350), plus the side outputs:

* ``<name>.tokens.txt`` — sherpa-style token table (export_onnx.py:57-94)
* ``<name>.piper.json`` — piper-compatible config for ipa+espeak voices
  (export_onnx.py:97-130)

Weight-norm is folded for the decoder (the reference calls
dec.remove_weight_norm before export, export_onnx.py:242-245); other
weight-normed modules keep (v, g) pairs exactly like the reference graph.

Export is a file conversion on the host, as the JAX version's numpy is: it
reads the checkpoint written by either package's trainer (``step_N.npz``)
and writes the graph with the port's copy of ``onnx/vits_graph.py``. The
card comes in when ``TTSVoice.load`` serves what it wrote.

Usage:
    python -m phoonnx_tpu_torch.train.export \\
        --checkpoint out/checkpoints/step_N.npz --config out/config.json \\
        --output-dir exported/
"""

import argparse
import json
import logging
from pathlib import Path
from typing import Any, Dict

import numpy as np

LOG = logging.getLogger("export")


def fold_decoder_weight_norm(params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold (v, g) -> weight in the HiFi-GAN decoder subtree."""
    from phoonnx_tpu_torch.models.vits import nn

    def fold(node):
        if isinstance(node, dict):
            if "weight_v" in node:
                folded = {k: v for k, v in node.items()
                          if k not in ("weight_v", "weight_g")}
                folded["weight"] = nn.weight_norm(
                    node["weight_v"], node["weight_g"]
                )
                return folded
            return {k: fold(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fold(v) for v in node]
        return node

    out = dict(params)
    out["dec"] = fold(params["dec"])
    return out


def export_tokens(phoneme_id_map: Dict[str, Any], output_path: Path) -> None:
    """sherpa tokens.txt: ``PHONEME<space>ID`` per line."""
    with open(output_path, "w", encoding="utf-8") as f:
        for phoneme, ids in phoneme_id_map.items():
            id_value = ids[0] if isinstance(ids, (list, tuple)) else ids
            f.write(f"{phoneme} {id_value}\n")


def convert_to_piper(config: Dict[str, Any], output_path: Path) -> None:
    """Piper-compatible voice config for ipa+espeak models."""
    phoneme_id_map = {
        k: v if isinstance(v, list) else [v]
        for k, v in config.get("phoneme_id_map", {}).items()
    }
    piper_config = {
        "audio": {
            "sample_rate": config.get("audio", {}).get("sample_rate", 22050),
            "quality": config.get("audio", {}).get("quality", "medium"),
        },
        "espeak": {"voice": config.get("lang_code", "en")},
        "language": {"code": config.get("lang_code", "en")},
        "inference": config.get("inference", {}),
        "phoneme_type": "espeak",
        "phoneme_map": {},
        "phoneme_id_map": phoneme_id_map,
        "num_symbols": config.get("num_symbols", len(phoneme_id_map)),
        "num_speakers": config.get("num_speakers", 1),
        "speaker_id_map": config.get("speaker_id_map", {}),
        "piper_version": "1.0.0",
    }
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(piper_config, f, ensure_ascii=False, indent=2)


def run_export(
    checkpoint: str,
    config_path: str,
    output_dir: str,
    quality: str = "medium",
    generate_tokens: bool = False,
    piper: bool = False,
    executable_graph: bool = True,
    quantize: bool = False,
) -> Path:
    import torch

    from phoonnx_tpu_torch.models.vits.load import params_to_flat
    from phoonnx_tpu_torch.onnx.writer import write_onnx
    from phoonnx_tpu_torch.train.checkpoint import restore_generator
    from phoonnx_tpu_torch.train.trainer import build_hparams

    with open(config_path, encoding="utf-8") as f:
        config = json.load(f)
    hp = build_hparams(config, quality)

    params_g = restore_generator(checkpoint, hp)
    with torch.no_grad():
        params = fold_decoder_weight_norm(params_g)
    flat = params_to_flat(params)

    output_path = Path(output_dir)
    output_path.mkdir(parents=True, exist_ok=True)
    name = Path(checkpoint).name
    model_output = output_path / f"{name}.onnx"

    alphabet = config.get("alphabet", "")
    phoneme_type = config.get("phoneme_type", "")
    metadata = {
        "model_type": "vits",
        "n_speakers": str(hp.n_speakers),
        "n_vocab": str(hp.n_vocab),
        "sample_rate": str(hp.sample_rate),
        "alphabet": alphabet,
        "phoneme_type": phoneme_type,
        "phonemizer_model": config.get("phonemizer_model") or "",
        "phoneme_id_map": json.dumps(
            config.get("phoneme_id_map", {}), ensure_ascii=False
        ),
        "has_espeak": str(phoneme_type == "espeak"),
        "decoder_type": hp.decoder_type,
        "istft_hop": str(hp.istft_hop),
        "istft_n_fft": str(hp.istft_n_fft),
        "istft_bands": str(hp.istft_bands),
    }
    if alphabet == "ipa" and phoneme_type == "espeak":
        metadata["comment"] = "piper"

    if executable_graph:
        # Full opset-15 inference graph: runs under onnxruntime (piper
        # ecosystem), the port's graph runner and the JAX package's
        # executor; the initializers keep the reference names so it also
        # reloads as a weight source.
        from phoonnx_tpu_torch.onnx.vits_graph import export_vits_onnx

        export_vits_onnx(
            {k: np.asarray(v) for k, v in flat.items()}, hp,
            str(model_output), metadata=metadata, quantize=quantize,
        )
    else:
        weights = {k: np.asarray(v) for k, v in flat.items()}
        if quantize:
            from phoonnx_tpu_torch.onnx.dequant import quantize_flat

            weights, n_q = quantize_flat(weights)
            if n_q:
                metadata["quantization"] = "int8-weights"
        inputs = [("input", np.int64, ("N", "T")),
                  ("input_lengths", np.int64, ("N",)),
                  ("scales", np.float32, (3,))]
        if hp.n_speakers > 1:
            inputs.append(("sid", np.int64, ("N",)))
        write_onnx(
            str(model_output),
            weights,
            metadata=metadata,
            inputs=inputs,
            outputs=[("output", np.float32, ("N", 1, "T_audio"))],
        )
    LOG.info("wrote %s (%d tensors)", model_output, len(flat))

    # config.json alongside the model for TTSVoice.load
    with open(f"{model_output}.json", "w", encoding="utf-8") as f:
        json.dump(config, f, ensure_ascii=False, indent=2)

    if generate_tokens:
        export_tokens(config.get("phoneme_id_map", {}),
                      output_path / f"{name}.tokens.txt")
    if piper:
        if not (alphabet == "ipa" and phoneme_type == "espeak"):
            LOG.warning(
                "only ipa+espeak voices are piper compatible; exporting "
                "anyway"
            )
        convert_to_piper(config, output_path / f"{name}.piper.json")
    return model_output


def main(argv=None) -> None:
    from phoonnx_tpu_torch.train.trainer import QUALITIES

    parser = argparse.ArgumentParser(
        description="Export a phoonnx_tpu_torch (or phoonnx_tpu) training "
                    "checkpoint as an ONNX voice.")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", dest="config_path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--quality", default="medium", choices=QUALITIES)
    parser.add_argument("--generate-tokens", action="store_true")
    parser.add_argument("--piper", action="store_true")
    parser.add_argument("--weights-only", dest="executable_graph",
                        action="store_false",
                        help="Write a weights-only container instead of the "
                             "executable inference graph")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 weight-only quantization (~4x smaller "
                             "model; QDQ triples, loads back to the native "
                             "engine and runs under onnxruntime)")
    parser.add_argument("--debug", action="store_true")
    args = vars(parser.parse_args(argv))
    debug = args.pop("debug")
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)
    run_export(**args)


if __name__ == "__main__":
    main()
