"""Neural-net primitives for the PyTorch VITS port.

Conventions (kept from the JAX package so the two compare like with like):

* Activations are ``[B, T, C]`` (channels-last) at every public function;
  the convolutions transpose to PyTorch's ``[B, C, T]`` internally.
* Conv weights keep the torch parameter layout ``[O, I/g, K]``
  (``[I, O/g, K]`` for transposed convs), so checkpoint import is a pure
  re-keying.
* Every function is pure: ``fn(params_subtree, x, ...) -> y``; parameter
  subtrees are plain dicts of tensors and Python ints.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def conv1d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> Tensor:
    """1D cross-correlation with torch.nn.Conv1d semantics on [B, T, C]."""
    y = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
                     stride: int = 1, padding: int = 0) -> Tensor:
    """1D transposed conv with torch.nn.ConvTranspose1d semantics; weight
    in the torch layout [I, O, K]."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight, bias, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def apply_conv(params, x: Tensor, **kw) -> Tensor:
    """Conv1d from a ``{"weight", "bias"?}`` parameter subtree."""
    return conv1d(x, params["weight"], params.get("bias"), **kw)


# ---------------------------------------------------------------------------
# Weight normalization
# ---------------------------------------------------------------------------


def weight_norm(v: Tensor, g: Tensor, eps: float = 0.0) -> Tensor:
    """w = g * v / ||v|| with the norm over all dims but 0 (torch default;
    for a transposed weight [I, O, K] that is the input axis)."""
    dims = tuple(range(1, v.ndim))
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return g * v / (norm + eps)


def resolve_weight(params) -> Tensor:
    """Weight from a conv subtree that may be weight-normalised (training
    checkpoints carry ``weight_v``/``weight_g``; exports a folded
    ``weight``)."""
    if "weight" in params:
        return params["weight"]
    return weight_norm(params["weight_v"], params["weight_g"])


def apply_wn_conv(params, x: Tensor, **kw) -> Tensor:
    return conv1d(x, resolve_weight(params), params.get("bias"), **kw)


# ---------------------------------------------------------------------------
# Normalization / activations
# ---------------------------------------------------------------------------


def layer_norm(params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the channel (last) axis; params: gamma/beta [C]."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return normed * params["gamma"] + params["beta"]


def leaky_relu(x: Tensor, slope: float = 0.1) -> Tensor:
    return torch.where(x >= 0, x, x * slope)


def gated_tanh_sigmoid(x: Tensor, g: Tensor, channels: int) -> Tensor:
    """tanh(a) * sigmoid(b) gate used by WaveNet blocks."""
    s = x + g
    return torch.tanh(s[..., :channels]) * torch.sigmoid(s[..., channels:])


def embedding(params, ids: Tensor) -> Tensor:
    """Token embedding lookup; params: weight [V, C]."""
    return params["weight"][ids]


class RowWindow(torch.Generator):
    """A generator for rows ``[start, start + n)`` of a batch of ``total``
    rows, starting from ``source``'s state: :func:`draw` makes each draw
    at the whole batch's shape and keeps the window's rows. A
    data-parallel rank so draws its rows of what one process draws for
    the whole batch, as JAX's global key does for a sharded batch."""

    def __new__(cls, source: torch.Generator, start: int, total: int):
        return super().__new__(cls, device=source.device)

    def __init__(self, source: torch.Generator, start: int, total: int):
        self.set_state(source.get_state())
        self.start, self.total = start, total


def draw(sample, shape, generator: torch.Generator, **kw) -> Tensor:
    """``sample(shape, generator=generator, **kw)`` for ``torch.rand`` or
    ``torch.randn``; from a :class:`RowWindow`, the window's rows of the
    draw at the whole batch's shape (``shape[0]`` is the window's
    size)."""
    if not isinstance(generator, RowWindow):
        return sample(shape, generator=generator, **kw)
    n = shape[0]
    if generator.start + n > generator.total:
        raise ValueError(f"rows [{generator.start}, {generator.start + n}) "
                         f"of a batch of {generator.total}")
    full = sample((generator.total, *shape[1:]), generator=generator, **kw)
    return full[generator.start:generator.start + n]


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> Tensor:
    """Inverted dropout with its mask drawn from ``generator`` (which
    lives on x's device); the identity when deterministic, at rate 0 or
    without a generator, as in the JAX package."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = draw(torch.rand, x.shape, generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def fold_weight_norm(tree):
    """Copy of a parameter tree with every weight-normalised conv's
    ``weight_v``/``weight_g`` replaced by its ``weight``
    (:func:`resolve_weight`, in the tree's dtype)."""
    if isinstance(tree, dict):
        out = {k: fold_weight_norm(v) for k, v in tree.items()
               if k not in ("weight_v", "weight_g")}
        if "weight_v" in tree and "weight" not in tree:
            out["weight"] = resolve_weight(tree)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(fold_weight_norm(v) for v in tree)
    return tree


def cast_floating(tree, dtype: torch.dtype):
    """Copy of a parameter tree with every floating tensor cast to
    ``dtype`` (other tensors and leaves kept), as the JAX engine's
    ``cast_floating``."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


# ---------------------------------------------------------------------------
# Masks and paths
# ---------------------------------------------------------------------------


def sequence_mask(lengths: Tensor, max_length: int) -> Tensor:
    """[B, T] boolean mask from lengths (True inside the sequence)."""
    positions = torch.arange(max_length, device=lengths.device)[None, :]
    return positions < lengths[:, None]


def zero_time_tail(x: Tensor, valid: Tensor, window_rows: int) -> Tensor:
    """Zero time positions ``[valid, valid + window_rows)`` of [B, T, C].

    Exact for the decoder's padding-invariance contract: a stride-1
    conv's valid outputs read at most ``(K-1)*d/2`` positions past
    ``valid`` (a transposed conv at most ``ceil(p/s)``), so zeroing that
    bleed window after each conv keeps a padded decode equal to the
    exact-length decode on the valid span. Positions past the window keep
    values no valid output reads. When the window covers the whole
    buffer every padded position is zeroed.
    """
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    valid = valid.to(torch.int64)[:, None]
    if t <= window_rows:
        kill = pos >= valid
    else:
        start = torch.clamp(valid, 0, t - window_rows)
        kill = (pos >= valid) & (pos >= start) & (pos < start + window_rows)
    return x.masked_fill(kill[..., None], 0.0)


def bleed_window_rows(max_extent: int) -> int:
    """Rows a :func:`zero_time_tail` window must span to cover a consumer
    reading ``max_extent`` positions past ``valid``."""
    return max_extent + 1


def generate_path(duration: Tensor, attn_mask: Tensor) -> Tensor:
    """Monotonic alignment from integer durations.

    duration: [B, T_x]; attn_mask: [B, T_y, T_x]. Returns the [B, T_y, T_x]
    one-hot-per-frame path. Frame counting stays in f32, which is exact
    below 2**24 frames.
    """
    t_y = attn_mask.shape[1]
    duration = duration.to(torch.float32)
    cum = torch.cumsum(duration, dim=-1)
    frames = torch.arange(t_y, dtype=torch.float32,
                          device=duration.device)[None, :, None]
    reached = frames < cum[:, None, :]
    started = frames < (cum - duration)[:, None, :]
    return (reached & ~started).to(attn_mask.dtype) * attn_mask


# ---------------------------------------------------------------------------
# Initializers (same tree and init schemes as the JAX package)
# ---------------------------------------------------------------------------


def _uniform(generator, shape, bound: float) -> Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def init_conv(generator, out_ch: int, in_ch: int, kernel: int,
              groups: int = 1, bias: bool = True,
              std: Optional[float] = None):
    """Kaiming-uniform conv init (torch Conv1d default) or normal(0, std)."""
    shape = (out_ch, in_ch // groups, kernel)
    fan_in = (in_ch // groups) * kernel
    if std is not None:
        weight = std * torch.randn(shape, generator=generator)
    else:
        weight = _uniform(generator, shape, math.sqrt(1.0 / fan_in)
                          * math.sqrt(3.0))
    params = {"weight": weight}
    if bias:
        params["bias"] = _uniform(generator, (out_ch,),
                                  math.sqrt(1.0 / fan_in))
    return params


def init_wn_conv(generator, out_ch, in_ch, kernel, groups=1, bias=True,
                 std=None):
    """Weight-normalised conv: store (v, g) with w = g v/||v||."""
    params = init_conv(generator, out_ch, in_ch, kernel, groups=groups,
                       bias=bias, std=std)
    v = params.pop("weight")
    dims = tuple(range(1, v.ndim))
    params["weight_v"] = v
    params["weight_g"] = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return params


def init_layer_norm(channels: int):
    return {"gamma": torch.ones(channels), "beta": torch.zeros(channels)}


def init_zero_conv(out_ch: int, in_ch: int, kernel: int = 1):
    """Zero-initialised projection (flows start at identity)."""
    return {"weight": torch.zeros(out_ch, in_ch, kernel),
            "bias": torch.zeros(out_ch)}
