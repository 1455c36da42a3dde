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

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from reference.vitstrain.model import VitsHParams, random_params


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


