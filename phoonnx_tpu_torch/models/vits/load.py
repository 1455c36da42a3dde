"""Checkpoint import: reference parameter names -> the port's parameter tree.

PyTorch port of ``phoonnx_tpu/models/vits/load.py``. The reference exports
ONNX graphs whose initializers keep the torch state_dict names
(phoonnx_train/export_onnx.py:318-327), and training checkpoints are
Lightning state dicts with a ``model_g.`` prefix. This module translates
the flat ``enc_p.encoder.attn_layers.0.conv_q.weight``-style names into the
parameter tree (plain dicts of CPU tensors) used by
:mod:`phoonnx_tpu_torch.models.vits.model`, and back.

Layout notes: conv kernels keep the torch layouts ([O, I/g, K] for Conv1d,
[I, O, K] for ConvTranspose1d) — see models/vits/nn.py — so values are
copied verbatim. Only ElementwiseAffine ([C, 1] -> [C]) is squeezed.
Floating values are stored as float32; a bfloat16 engine casts them
(``VitsEngine(dtype="bfloat16")``, ``nn.cast_floating``).
"""

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from phoonnx_tpu_torch.models.vits.model import VitsHParams, random_params


def _to_tensor(value: np.ndarray) -> torch.Tensor:
    value = np.asarray(value)
    if np.issubdtype(value.dtype, np.floating):
        value = value.astype(np.float32)
    return torch.from_numpy(np.array(value, copy=True))


def _set_leaf(tree: Dict[str, Any], path: Tuple, value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    leaf = path[-1]
    if leaf == "weight" and isinstance(node, dict) and "weight_v" in node:
        # Folded (inference) weights replace the weight-norm pair.
        node.pop("weight_v", None)
        node.pop("weight_g", None)
    node[leaf] = _to_tensor(value)


def _route(name: str) -> Optional[Tuple]:
    """Translate a reference parameter name to a pytree path.

    Returns None for anything unroutable — including names that merely
    START like a parameter (torch-trace helper tensors such as
    ``flow.flows.0/norm_axes`` or ``dec.ups.0.weight/transposed``): a
    malformed index must read as "not a parameter", never abort the
    import of an otherwise valid voice.
    """
    try:
        return _route_checked(name)
    except (ValueError, IndexError, KeyError):
        return None


def _route_checked(name: str) -> Optional[Tuple]:
    parts = name.split(".")
    top = parts[0]

    if top == "emb_g":
        return ("emb_g", parts[1])

    if top == "enc_p":
        if parts[1] == "emb":
            return ("enc_p", "emb", parts[2])
        if parts[1] == "proj":
            return ("enc_p", "proj", parts[2])
        if parts[1] == "encoder":
            kind, idx = parts[2], int(parts[3])
            rest = parts[4:]
            base = ("enc_p", "encoder", "layers", idx)
            if kind == "attn_layers":
                return base + ("attn",) + tuple(rest)
            if kind == "norm_layers_1":
                return base + ("norm_1",) + tuple(rest)
            if kind == "ffn_layers":
                return base + ("ffn",) + tuple(rest)
            if kind == "norm_layers_2":
                return base + ("norm_2",) + tuple(rest)
        return None

    if top == "dec":
        if parts[1] in ("conv_pre", "conv_post", "cond", "conv_mag",
                        "conv_phase"):
            return ("dec", parts[1], parts[2])
        if parts[1] == "ups":
            return ("dec", "ups", int(parts[2]), parts[3])
        if parts[1] == "resblocks":
            idx = int(parts[2])
            conv_list, conv_idx = parts[3], int(parts[4])
            return ("dec", "resblocks", idx, conv_list, conv_idx, parts[5])
        return None

    if top == "enc_q":
        if parts[1] in ("pre", "proj"):
            return ("enc_q", parts[1], parts[2])
        if parts[1] == "enc":
            return ("enc_q", "enc") + _route_wn(parts[2:])
        return None

    if top == "flow":
        # torch flow.flows indices 0,2,4,6 are coupling layers (odd = Flip,
        # parameterless — an odd index here is NOT a real parameter and
        # must read as unroutable, not alias onto idx//2)
        if parts[1] != "flows":
            return None
        idx = int(parts[2])
        if idx % 2:
            return None
        base = ("flow", "flows", idx // 2)
        if parts[3] in ("pre", "post"):
            return base + (parts[3], parts[4])
        if parts[3] == "enc":
            return base + ("enc",) + _route_wn(parts[4:])
        return None

    if top == "dp":
        return _route_dp(parts[1:])

    return None


def _route_wn(parts) -> Tuple:
    """WN inner naming: in_layers.N / res_skip_layers.N / cond_layer."""
    if parts[0] == "cond_layer":
        return ("cond_layer", parts[1])
    return (parts[0], int(parts[1]), parts[2])


def _route_dds(parts) -> Tuple:
    """DDSConv naming: convs_sep.N / convs_1x1.N / norms_1.N / norms_2.N."""
    kind, idx = parts[0], int(parts[1])
    sub = {"convs_sep": "sep", "convs_1x1": "pointwise",
           "norms_1": "norm1", "norms_2": "norm2"}[kind]
    return ("layers", idx, sub, parts[2])


def _route_dp(parts) -> Optional[Tuple]:
    head = parts[0]
    if head in ("pre", "proj", "post_pre", "post_proj", "cond",
                "conv_1", "conv_2", "norm_1", "norm_2"):
        return ("dp", head, parts[1])
    if head in ("convs", "post_convs"):
        return ("dp", head) + _route_dds(parts[1:])
    if head in ("flows", "post_flows"):
        t_idx = int(parts[1])
        my_idx = (t_idx + 1) // 2  # 0->0 (EA), 1->1, 3->2, 5->3, 7->4 (CF)
        if t_idx == 0:
            return ("dp", head, 0, "ea", parts[2])
        if t_idx % 2 == 1:
            rest = parts[2:]
            base = ("dp", head, my_idx, "cf")
            if rest[0] in ("pre", "proj"):
                return base + (rest[0], rest[1])
            if rest[0] == "convs":
                return base + ("convs",) + _route_dds(rest[1:])
        return None  # Flip layers have no parameters
    return None


_STRIP_PREFIXES = ("model_g.", "_orig_mod.")

_WEIGHT_CONSUMERS = ("Conv", "ConvTranspose", "Gemm", "MatMul")


def recover_anonymous_weights(model) -> Dict[str, np.ndarray]:
    """Initializers re-keyed by state-dict name, recovering the names
    torch's exporter erased.

    ``torch.onnx.export`` constant-folds by default, which collapses
    every weight-norm (v, g -> Mul/Div) chain into a fresh initializer
    named ``onnx::Conv_NNNN`` — the state-dict name is GONE from the
    tensor (observed on the reference exporter recipe: all 32 of the
    flow's WN conv weights). Identical tensors are also deduplicated
    into one initializer consumed by several nodes. A by-name import
    would silently leave those leaves at random init (and the untrained
    reference's zero post projections make the resulting parity LOOK
    fine — the coupling degenerates to identity — so only trained
    weights expose it).

    Recovery uses the graph itself: the consuming node's bias input
    still carries the state-dict name (``X.bias`` -> the weight is
    ``X.weight``), and failing that the torchscript node name encodes
    the module path (``/flow/flows.6/enc/in_layers.0/Conv``). Anonymous
    names that were recovered are dropped from the result; everything
    else passes through unchanged.
    """
    named = dict(model.initializers)
    recovered_sources = set()
    for node in model.nodes:
        if node.op_type not in _WEIGHT_CONSUMERS or len(node.inputs) < 2:
            continue
        w_name = node.inputs[1]
        value = named.get(w_name)
        if value is None or _route(w_name) is not None:
            continue
        base = None
        if (len(node.inputs) > 2 and node.inputs[2] in named
                and node.inputs[2].endswith(".bias")
                and _route(node.inputs[2]) is not None):
            base = node.inputs[2][: -len(".bias")]
        elif getattr(node, "name", None):
            # '/flow/flows.6/enc/in_layers.0/Conv' -> module path
            parts = [p for p in node.name.split("/") if p]
            if len(parts) >= 2:
                base = ".".join(parts[:-1])
        if base is None:
            continue
        new_name = base + ".weight"
        if new_name in named or _route(new_name) is None:
            continue
        named[new_name] = value
        recovered_sources.add(w_name)
    for w_name in recovered_sources:
        named.pop(w_name, None)
    return named


def routed_fraction(named: Mapping[str, np.ndarray]) -> float:
    """Fraction of flat names the importer can route into the VITS tree.

    ~1.0 for training state dicts / weight-only exports, ~0.8 for this
    framework's executable graphs (constants don't route), ~0.0 for
    foreign graphs (coqui-VITS, mimic3) — used by TTSVoice.load to refuse
    voices that are not in the VITS weight layout.
    """
    if not named:
        return 0.0
    routed = 0
    for name in named:
        for prefix in _STRIP_PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        if _route(name) is not None:
            routed += 1
    return routed / len(named)


def params_from_flat(
    named: Mapping[str, np.ndarray],
    hp: VitsHParams,
    strict: bool = True,
) -> Dict[str, Any]:
    """Build a parameter pytree from flat reference-named arrays.

    ``named`` maps reference names (state_dict or ONNX initializer names) to
    arrays. Unroutable names are collected; ``strict`` raises if any routed
    leaf of the skeleton was never filled (shape mismatches always raise).
    """
    params = random_params(hp, torch.Generator().manual_seed(0))
    filled, unmatched = fill_from_flat(params, named)
    if strict:
        if unmatched:
            raise ValueError(f"unrouted parameters: {unmatched[:10]}"
                             f" (+{max(0, len(unmatched) - 10)} more)")
        # every leaf of the final skeleton must come from the checkpoint:
        # a partially-saved file would otherwise run with random_params
        # initialization in the missing slots and synthesize noise
        unfilled = [p for p in _leaf_paths(params) if p not in filled]
        if unfilled:
            raise ValueError(
                f"checkpoint leaves missing: {unfilled[:10]}"
                f" (+{max(0, len(unfilled) - 10)} more)")
    return params


def fill_from_flat(params: Dict[str, Any], named: Mapping[str, np.ndarray]
                   ) -> Tuple[set, list]:
    """Write every routable array of ``named`` into the tree ``params``
    (in place, as CPU tensors; a folded ``weight`` replaces its
    weight-norm pair). Returns (the filled paths, the unrouted names)."""
    unmatched = []
    filled = set()
    for raw_name, value in named.items():
        name = raw_name
        for prefix in _STRIP_PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        path = _route(name)
        if path is None:
            unmatched.append(raw_name)
            continue
        value = np.asarray(value)
        if path[-1] in ("m", "logs") and value.ndim == 2:
            value = value[:, 0]  # ElementwiseAffine [C,1] -> [C]
        _check_shape(params, path, value, raw_name)
        _set_leaf(params, path, value)
        filled.add(path)
    return filled, unmatched


def _leaf_paths(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaf_paths(sub, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaf_paths(sub, prefix + (i,))
    elif hasattr(tree, "shape"):  # arrays only — skip metadata ints/strs
        yield prefix


def _check_shape(params, path, value, name) -> None:
    node: Any = params
    try:
        for key in path[:-1]:
            node = node[key]
        current = node.get(path[-1]) if isinstance(node, dict) else None
    except (KeyError, IndexError, TypeError):
        raise ValueError(f"no slot for parameter {name} at {path}") from None
    if current is None:
        # folded inference weight replacing a weight-norm pair is the
        # ONE legitimate missing-leaf case (_set_leaf swaps them)
        if path[-1] == "weight" and isinstance(node, dict) \
                and "weight_v" in node:
            if tuple(node["weight_v"].shape) != tuple(value.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(value.shape)} vs model "
                    f"{tuple(node['weight_v'].shape)}")
            return
        # anything else would INJECT a foreign leaf into the pytree
        # while the real parameter stays at random init (e.g. a
        # dequant-refused X_quantized triple) — a voice that
        # synthesizes noise with no error
        raise ValueError(
            f"no slot for parameter {name}: leaf {path[-1]!r} is not "
            f"part of the model skeleton at {path[:-1]}")
    if tuple(current.shape) != tuple(value.shape):
        if path[-1] == "weight" and "weight_v" in node:
            expected = node["weight_v"].shape
            if tuple(expected) == tuple(value.shape):
                return
        raise ValueError(
            f"shape mismatch for {name}: checkpoint {tuple(value.shape)} "
            f"vs model {tuple(current.shape)}"
        )


def params_to_flat(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_flat`: pytree -> reference-named arrays.

    Used to write voices (``onnx.writer.write_onnx``) that the reference
    toolchain and this importer read by name.
    """
    flat: Dict[str, np.ndarray] = {}

    def emit(name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        if name.endswith((".m", ".logs")) and np.ndim(value) == 1:
            value = np.asarray(value)[:, None]  # ElementwiseAffine [C]->[C,1]
        flat[name] = np.asarray(value)

    def walk_leaf_dict(prefix: str, node: Dict[str, Any]) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk_leaf_dict(f"{prefix}.{key}", value)
            elif isinstance(value, (list, tuple)):
                for i, item in enumerate(value):
                    walk_leaf_dict(f"{prefix}.{key}.{i}", item)
            elif hasattr(value, "shape"):
                emit(f"{prefix}.{key}", value)
            # non-array metadata (ints/strs) is skipped

    # enc_p
    enc_p = params["enc_p"]
    emit("enc_p.emb.weight", enc_p["emb"]["weight"])
    for i, layer in enumerate(enc_p["encoder"]["layers"]):
        for sub, ref in (("attn", "attn_layers"), ("ffn", "ffn_layers")):
            walk_leaf_dict(f"enc_p.encoder.{ref}.{i}", layer[sub])
        walk_leaf_dict(f"enc_p.encoder.norm_layers_1.{i}", layer["norm_1"])
        walk_leaf_dict(f"enc_p.encoder.norm_layers_2.{i}", layer["norm_2"])
    walk_leaf_dict("enc_p.proj", enc_p["proj"])

    # dec
    dec = params["dec"]
    walk_leaf_dict("dec.conv_pre", dec["conv_pre"])
    for head in ("conv_post", "conv_mag", "conv_phase", "cond"):
        if head in dec:
            walk_leaf_dict(f"dec.{head}", dec[head])
    for i, up in enumerate(dec["ups"]):
        walk_leaf_dict(f"dec.ups.{i}", up)
    for j, block in enumerate(dec["resblocks"]):
        for conv_list in ("convs", "convs1", "convs2"):
            if conv_list in block:
                for k, conv in enumerate(block[conv_list]):
                    walk_leaf_dict(
                        f"dec.resblocks.{j}.{conv_list}.{k}", conv
                    )

    # enc_q
    enc_q = params["enc_q"]
    walk_leaf_dict("enc_q.pre", enc_q["pre"])
    walk_leaf_dict("enc_q.proj", enc_q["proj"])
    _walk_wn("enc_q.enc", enc_q["enc"], walk_leaf_dict)

    # flow (torch indices are 0,2,4,6 — odd slots are parameterless flips)
    for i, layer in enumerate(params["flow"]["flows"]):
        base = f"flow.flows.{2 * i}"
        walk_leaf_dict(f"{base}.pre", layer["pre"])
        walk_leaf_dict(f"{base}.post", layer["post"])
        _walk_wn(f"{base}.enc", layer["enc"], walk_leaf_dict)

    # dp
    dp = params["dp"]
    for head in ("pre", "proj", "post_pre", "post_proj", "cond",
                 "conv_1", "conv_2", "norm_1", "norm_2"):
        if head in dp:
            walk_leaf_dict(f"dp.{head}", dp[head])
    for head in ("convs", "post_convs"):
        if head in dp:
            _walk_dds(f"dp.{head}", dp[head], walk_leaf_dict)
    for head in ("flows", "post_flows"):
        if head not in dp:
            continue
        for my_idx, flow in enumerate(dp[head]):
            if "ea" in flow:
                emit(f"dp.{head}.0.m", flow["ea"]["m"])
                emit(f"dp.{head}.0.logs", flow["ea"]["logs"])
            else:
                t_idx = 2 * my_idx - 1
                cf = flow["cf"]
                walk_leaf_dict(f"dp.{head}.{t_idx}.pre", cf["pre"])
                walk_leaf_dict(f"dp.{head}.{t_idx}.proj", cf["proj"])
                _walk_dds(f"dp.{head}.{t_idx}.convs", cf["convs"],
                          walk_leaf_dict)

    if "emb_g" in params:
        emit("emb_g.weight", params["emb_g"]["weight"])
    return flat


def _walk_wn(prefix: str, wn_params: Dict[str, Any], walk) -> None:
    for i, layer in enumerate(wn_params["in_layers"]):
        walk(f"{prefix}.in_layers.{i}", layer)
    for i, layer in enumerate(wn_params["res_skip_layers"]):
        walk(f"{prefix}.res_skip_layers.{i}", layer)
    if "cond_layer" in wn_params:
        walk(f"{prefix}.cond_layer", wn_params["cond_layer"])


def _walk_dds(prefix: str, dds_params: Dict[str, Any], walk) -> None:
    sub_names = {"sep": "convs_sep", "pointwise": "convs_1x1",
                 "norm1": "norms_1", "norm2": "norms_2"}
    for i, layer in enumerate(dds_params["layers"]):
        for mine, ref in sub_names.items():
            walk(f"{prefix}.{ref}.{i}", layer[mine])


def infer_hparams_from_flat(named: Mapping[str, np.ndarray],
                            **overrides) -> VitsHParams:
    """Deduce model hyperparameters from checkpoint tensor shapes.

    Works on both training state dicts and exported initializers (the
    exported graph keeps the state_dict names, export_onnx.py:318-327).
    """
    names = set()
    shapes = {}
    for raw in named:
        name = raw
        for prefix in _STRIP_PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        names.add(name)
        shapes[name] = tuple(np.asarray(named[raw]).shape)

    def shape(key):
        return shapes.get(key)

    emb = shape("enc_p.emb.weight")
    n_vocab, hidden = emb if emb else (256, 192)
    proj = shape("enc_p.proj.weight")
    inter = proj[0] // 2 if proj else hidden
    ffn1 = shape("enc_p.encoder.ffn_layers.0.conv_1.weight")
    filter_channels = ffn1[0] if ffn1 else 768

    n_layers = 1 + max(
        (int(m.group(1)) for n in names
         for m in [re.match(r"enc_p\.encoder\.attn_layers\.(\d+)\.", n)] if m),
        default=5,
    )

    pre_q = shape("enc_q.pre.weight")
    spec_channels = pre_q[1] if pre_q else 513

    n_ups = 1 + max(
        (int(m.group(1)) for n in names
         for m in [re.match(r"dec\.ups\.(\d+)\.", n)] if m),
        default=2,
    )
    up0 = shape("dec.ups.0.weight") or shape("dec.ups.0.weight_v")
    upsample_initial = up0[0] if up0 else 256

    n_resblocks = 1 + max(
        (int(m.group(1)) for n in names
         for m in [re.match(r"dec\.resblocks\.(\d+)\.", n)] if m),
        default=8,
    )
    num_kernels = n_resblocks // n_ups
    has_convs2 = any(re.match(r"dec\.resblocks\.0\.convs2\.", n) for n in names)
    resblock = "1" if has_convs2 else "2"

    # Upsample kernels read off the transposed-conv shapes; rate = kernel/2
    # holds for every shipped preset ((16,16,8) and (16,16,4,4)).
    upsample_kernels = tuple(
        (shape(f"dec.ups.{i}.weight") or shape(f"dec.ups.{i}.weight_v")
         or (None, None, 16))[2]
        for i in range(n_ups)
    )
    upsample_rates = tuple(k // 2 for k in upsample_kernels)
    if resblock == "1":
        rb_kernels = (3, 7, 11)[:num_kernels]
        rb_dilations = tuple((1, 3, 5) for _ in range(num_kernels))
    else:
        rb_kernels = (3, 5, 7)[:num_kernels]
        rb_dilations = ((1, 2), (2, 6), (3, 12))[:num_kernels]
    # Refine from actual kernel shapes where available.
    rb_kernels = tuple(
        (shape(f"dec.resblocks.{j}.convs1.0.weight")
         or shape(f"dec.resblocks.{j}.convs1.0.weight_v")
         or shape(f"dec.resblocks.{j}.convs.0.weight")
         or shape(f"dec.resblocks.{j}.convs.0.weight_v")
         or (None, None, rb_kernels[j % num_kernels]))[2]
        for j in range(num_kernels)
    )

    emb_g = shape("emb_g.weight")
    n_speakers, gin = emb_g if emb_g else (1, 0)
    use_sdp = any(n.startswith("dp.flows.") for n in names)

    decoder_type = "hifigan"
    istft_n_fft, istft_hop, istft_bands = 16, 4, 1
    mag = shape("dec.conv_mag.weight")
    if mag is not None:
        decoder_type = "istft"
        # multi-band heads emit bands*(n_fft/2+1) channels; with the
        # canonical n_fft=16 that is a multiple of 9 (metadata overrides
        # istft_n_fft/istft_bands for non-canonical exports)
        if mag[0] > 9 and mag[0] % 9 == 0:
            istft_bands = mag[0] // 9
            istft_n_fft = 16
        else:
            istft_n_fft = 2 * (mag[0] - 1)

    hp = VitsHParams(
        n_vocab=n_vocab,
        spec_channels=spec_channels,
        inter_channels=inter,
        hidden_channels=hidden,
        filter_channels=filter_channels,
        n_layers=n_layers,
        resblock=resblock,
        resblock_kernel_sizes=rb_kernels,
        resblock_dilation_sizes=rb_dilations,
        upsample_rates=upsample_rates,
        upsample_initial_channel=upsample_initial,
        upsample_kernel_sizes=upsample_kernels,
        n_speakers=n_speakers,
        gin_channels=gin,
        use_sdp=use_sdp,
        decoder_type=decoder_type,
        istft_n_fft=istft_n_fft,
        istft_hop=istft_hop,
        istft_bands=istft_bands,
    )
    if overrides:
        from dataclasses import replace

        hp = replace(hp, **overrides)
    return hp
