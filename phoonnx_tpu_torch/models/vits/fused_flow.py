"""Kernel B: the inverse coupling-flow stack as a hand-written CUDA kernel.

Wrapper of ``csrc/fused_flow.cu``, which replaces the Pallas kernel
``phoonnx_tpu/models/vits/fused_flow.py`` (``_kernel`` :217, ``apply``
:287). It computes ``posterior.coupling_flow_plain(..., reverse=True)``:
n_flows x [channel flip, mean-only coupling with a gated WaveNet], as ONE
cooperative launch of persistent blocks that walk the flows' phases; its
design note is at the top of the CUDA source.

:func:`build_spec` stacks the per-coupling weights in processing order
with the channel flips folded in (even steps reverse the ``pre`` input
axis and the ``post`` output axis), so the kernel only swaps which half
it reads and which it updates. :func:`apply` launches the kernel for a
CUDA tensor and runs the plain version for a CPU tensor.
"""

from typing import Optional

import torch

from phoonnx_tpu_torch import cuda, tiling
from phoonnx_tpu_torch.models.vits import nn

LIBRARY = "fused_flow"

# Launches of the kernel (one per apply on the card).
launches = 0


def _gate_pairs(w: torch.Tensor, hidden: int) -> torch.Tensor:
    """Interleave the gate's halves along the last axis, per WaveNet layer
    (its width is a multiple of 2 x hidden): [tanh_0..tanh_h-1,
    sig_0..sig_h-1] -> [tanh_0, sig_0, tanh_1, sig_1, ...], so the kernel
    finds a channel's two gate inputs in adjacent columns."""
    shape = w.shape
    return w.reshape(*shape[:-1], -1, 2, hidden).transpose(-1, -2) \
        .reshape(shape)


def build_spec(flow_params):
    """Stacked-weight spec for the REVERSE pass of ``coupling_flow``, or
    None when the layout is not the uniform VITS flow stack. The WaveNet
    in-convs' output columns (and the speaker terms') are interleaved by
    :func:`_gate_pairs`."""
    flows = flow_params.get("flows")
    if not flows or len(flows) % 2 != 0:
        return None
    enc0 = flows[0]["enc"]
    half = int(flows[0]["half_channels"])
    hidden = int(enc0["hidden"])
    k = int(enc0["kernel_size"])
    dil = int(enc0["dilation_rate"])
    n_layers = int(enc0["n_layers"])
    has_cond = "cond_layer" in enc0

    w_pre, b_pre, w_in, b_in, w_rs, b_rs = [], [], [], [], [], []
    w_post, b_post, cond_w, cond_b = [], [], [], []
    for j, flow in enumerate(reversed(flows)):
        enc = flow["enc"]
        post_w = flow["post"]["weight"]
        if (int(flow["half_channels"]) != half
                or int(enc["hidden"]) != hidden
                or int(enc["kernel_size"]) != k
                or int(enc["dilation_rate"]) != dil
                or int(enc["n_layers"]) != n_layers
                or ("cond_layer" in enc) != has_cond
                or post_w.shape[0] != half):
            return None
        fold = j % 2 == 0
        wp = flow["pre"]["weight"][:, :, 0].T  # [half, hidden]
        w_pre.append(wp.flip(0) if fold else wp)
        b_pre.append(flow["pre"]["bias"][None])

        wi, bi_, wr, br = [], [], [], []
        for i in range(n_layers):
            wi.append(_gate_pairs(
                nn.resolve_weight(enc["in_layers"][i]).permute(2, 1, 0),
                hidden))
            bi_.append(_gate_pairs(enc["in_layers"][i]["bias"], hidden)[None])
            rs = nn.resolve_weight(enc["res_skip_layers"][i])[:, :, 0].T
            rb = enc["res_skip_layers"][i]["bias"][None]
            if i == n_layers - 1:
                # the last layer emits skip only ([h] wide): place it in
                # the skip half so the res/skip split is uniform
                rs = torch.cat([torch.zeros_like(rs), rs], dim=1)
                rb = torch.cat([torch.zeros_like(rb), rb], dim=1)
            wr.append(rs)
            br.append(rb)
        w_in.append(torch.stack(wi))
        b_in.append(torch.stack(bi_))
        w_rs.append(torch.stack(wr))
        b_rs.append(torch.stack(br))

        wq = post_w[:, :, 0].T  # [hidden, half]
        bq = flow["post"]["bias"]
        w_post.append(wq.flip(1) if fold else wq)
        b_post.append((bq.flip(0) if fold else bq)[None])
        if has_cond:
            cw = nn.resolve_weight(enc["cond_layer"])[:, :, 0]  # [L*2h, gin]
            cond_w.append(_gate_pairs(cw.T, hidden))
            bias = enc["cond_layer"].get("bias")
            cond_b.append(_gate_pairs(
                cw.new_zeros(cw.shape[0]) if bias is None else bias, hidden))

    def stack(items):
        return torch.stack(items).contiguous()

    spec = {
        "n_flows": len(flows), "n_layers": n_layers, "half": half,
        "hidden": hidden, "kernel_size": k, "dilation_rate": dil,
        "w_pre": stack(w_pre), "b_pre": stack(b_pre),
        "w_in": stack(w_in), "b_in": stack(b_in),
        "w_rs": stack(w_rs), "b_rs": stack(b_rs),
        "w_post": stack(w_post), "b_post": stack(b_post),
        "plain": flow_params,
    }
    if has_cond:
        spec["cond_w"] = stack(cond_w)
        spec["cond_b"] = stack(cond_b)
    return spec


_WEIGHTS = ("w_pre", "b_pre", "w_in", "b_in", "w_rs", "b_rs", "w_post",
            "b_post")


def plain(spec, x: torch.Tensor, x_mask: torch.Tensor,
          g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function the kernel computes, in plain PyTorch ops."""
    from phoonnx_tpu_torch.models.vits.posterior import coupling_flow_plain

    return coupling_flow_plain(spec["plain"], x, x_mask, g=g, reverse=True)


def apply(spec, x: torch.Tensor, x_mask: torch.Tensor,
          g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reverse the coupling stack. x [B, T, C] (z_p), x_mask [B, T, 1],
    g [B, 1, gin] or None -> z [B, T, C]."""
    if not x.is_cuda:
        return plain(spec, x, x_mask, g=g)
    return launch(spec, x, x_mask, g=g)


def _speaker_terms(spec, g, batch: int):
    """[B, n_flows, n_layers, 2*hidden] conditioning added to every WN
    layer's input conv (a small product outside the kernel, as on the
    TPU), or None."""
    if "cond_w" not in spec:
        if g is not None:
            raise ValueError(
                "fused flow received speaker conditioning but was built "
                "without gin_channels (hparams/checkpoint mismatch)")
        return None
    if g is None:
        # mirror modules.wn: dropping g would synthesize
        # speaker-unconditioned audio on an hparams mismatch
        raise ValueError(
            "fused flow has speaker conditioning but no g was passed")
    g_all = (torch.einsum("bg,fgh->bfh", g[:, 0, :], spec["cond_w"])
             + spec["cond_b"])
    return g_all.reshape(batch, spec["n_flows"], spec["n_layers"],
                         2 * spec["hidden"]).contiguous()


def phases(spec) -> list:
    """The kernel's phases in order, as ``launch``'s stamps time them."""
    layers = [name for i in range(spec["n_layers"])
              for name in (f"in_gate {i}", f"res_skip {i}")]
    return [f"{name} flow {f}" for f in range(spec["n_flows"])
            for name in ("pre", *layers, "post")]


def launch(spec, x: torch.Tensor, x_mask: torch.Tensor,
           g: Optional[torch.Tensor] = None,
           stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B on the card (no plain path): one cooperative launch. With
    ``stamps`` (int64, ``len(phases(spec)) + 1`` on the card) the kernel
    also writes the device clock (ns) at its start and at the end of
    each phase."""
    global launches
    b, t, c = x.shape
    dev = x.device
    half, hidden = spec["half"], spec["hidden"]
    cuda.require(x, "x", dev)
    if c != 2 * half:
        raise ValueError(f"x has {c} channels, the spec {2 * half}")
    for name in _WEIGHTS:
        cuda.require(spec[name], name, dev)
    g_all = _speaker_terms(spec, g, b)
    if g_all is not None:
        cuda.require(g_all, "g", dev)
    grid = tiling.grid_size(*cuda.occupancy(LIBRARY, "fused_flow_occupancy"))
    lengths = x_mask[:, :, 0].sum(dim=1).to(torch.int32).contiguous()
    out = torch.empty_like(x)
    # hbuf, acts, skip: freed at return, reused only after the kernel
    _, bufs = cuda.scratch(dev, (b * t * hidden,) * 3)
    if stamps is not None:
        cuda.require(stamps, "stamps", dev, torch.int64,
                     (len(phases(spec)) + 1,))
    fn = cuda.function(LIBRARY, "fused_flow_reverse",
                       [cuda.c_ptr] * 16 + [cuda.c_int] * 9 + [cuda.c_ptr])
    status = fn(cuda.ptr(x), cuda.ptr(out), cuda.ptr(lengths),
                cuda.ptr(g_all), *[cuda.ptr(spec[n]) for n in _WEIGHTS],
                *bufs, cuda.ptr(stamps), b, t, half, hidden,
                spec["kernel_size"], spec["dilation_rate"], spec["n_layers"],
                spec["n_flows"], grid, cuda.stream_of(x))
    cuda.check(LIBRARY, status, "fused_flow_reverse")
    launches += 1
    return out
