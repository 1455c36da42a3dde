"""ONNX graphs on a PyTorch device: the port of ``phoonnx_tpu/onnx/jax_lowering.py``.

The JAX package lowers a foreign voice's ONNX graph to jitted XLA
segments (``JaxGraphRunner``): a plan pass on the numpy interpreter
classifies every value, the nodes between data-dependent boundaries are
compiled per input signature, and what cannot be staged replays on the
interpreter. PyTorch has dynamic shapes natively, so
:class:`TorchGraphRunner` needs none of that: no plan, no segments, no
interpreter replay. It keeps the initializers on its device once, walks
the graph in node order and runs each node as torch ops on that device,
through an op table (``_t_<op>``, mirroring the JAX ``_j_<op>``
handlers) that covers every op of the interpreter's table
(:data:`phoonnx_tpu_torch.onnx.executor._OPS`), plus ``If``, ``Loop``,
``RandomNormalLike`` and the pre-13 ``Softmax``/``LogSoftmax``, which the
interpreter intercepts as well. ``If`` runs the branch its condition
picks; ``Loop`` runs its body on the device and reads its condition on
the host once a trip.

What touches the host, and nothing else:

* **Shape arithmetic.** ``Shape``/``Size`` outputs are host values (numpy
  int64) taken from the tensor's shape without a read. A node whose
  inputs are all small host integers (at most :data:`HOST_MAX`
  elements) and whose outputs are too runs on the interpreter's own
  numpy handler: the shape math of a graph (gathers of a shape, concats
  of dims, products) stays on the host. Small integer initializers and
  ``Constant`` outputs, and small integer feeds, start there; they are
  copied to the device (once, for constants) where a device op takes them
  as data. The integer values that feed shape-requiring slots (a
  ``Reshape``/``Expand``/``Tile`` target, ``Slice`` bounds, ``Pad``
  widths and value, ``Range``, ``TopK``, ``OneHot`` and ``Loop``
  counts, reduction axes) are read on the host; a read of a device value
  waits for the device and is counted (``RunStats.reads``).
* **Noise.** ``RandomNormalLike`` draws come from the interpreter's numpy
  RNG (``runner.executor``) in node order, as ``_HostDraw`` draws them in
  the JAX runner, and are copied to the device: a seeded run draws
  exactly the interpreter's noise and the JAX engine's.

Every floating-point value and every tensor of data lives on the device.
An op with no lowering raises ``NotImplementedError`` naming the op and
the node, as the interpreter does; nothing is replayed on the host.

Numerics follow the interpreter's op semantics (ONNX integer ``Div``
truncates, ``Mod`` follows ``fmod``, ``Round`` is half to even, ``TopK``
ties keep the lower index, ...). Floating-point results differ from it
by the kernels' reassociation. Integer and quantized ops are bit-exact:
``MatMulInteger``, ``ConvInteger``, ``QLinearMatMul`` and
``QLinearConv`` multiply in float64 on the device, where every int8
product sum of this size is exact (CUDA has no int64 ``matmul`` nor
integer convolution), and requantize in float32 single rounding as the
interpreter does. Differences from the JAX runner: ``Gather`` indices are
clamped to the axis as in JAX (the interpreter raises out of range); a
plain-assignment scatter with duplicate indices keeps an unspecified
write on CUDA, as XLA does (the JAX runner replays such scatters on the
interpreter).

``matmul_precision`` enters the engine's scope
(:func:`phoonnx_tpu_torch.infer.engine._prec_scope`) around every run.
"""

import collections
import functools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from phoonnx_tpu_torch.infer.engine import _prec_scope, resolve_device
from phoonnx_tpu_torch.onnx import executor as ex
from phoonnx_tpu_torch.onnx.executor import (
    OnnxExecutor,
    _attr,
    _conv_pad_list,
    _guard_rnn_attrs,
)
from phoonnx_tpu_torch.onnx.reader import OnnxModel, OnnxNode

# the most elements a host (shape-arithmetic) value may hold: a 4-D pad
# list; phoneme ids are padded to at least 16, so they are never host
HOST_MAX = 8


def _host_ok(arr: np.ndarray) -> bool:
    """Whether a numpy value may stay on the host: a small integer or
    boolean array."""
    return arr.dtype.kind in "biu" and arr.size <= HOST_MAX


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # a fresh C-ordered copy: numpy values may be read-only or strided
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class _ShapeOnly:
    """Stand-in for a tensor whose shape alone is needed."""

    def __init__(self, shape):
        self.shape = shape


@dataclass
class RunStats:
    """Where one run's values were: ``nodes`` executed (subgraphs
    included), node outputs by place (``"host"`` or the device type),
    host-value outputs by op type, host reads of device values by the op
    that needed them, host-to-device copies, and each host output as
    (op type, node name, dtype, elements)."""

    nodes: int = 0
    outputs: "collections.Counter[str]" = field(
        default_factory=collections.Counter)
    host_nodes: "collections.Counter[str]" = field(
        default_factory=collections.Counter)
    reads: "collections.Counter[str]" = field(
        default_factory=collections.Counter)
    uploads: int = 0
    host_outputs: List[Tuple[str, str, str, int]] = field(
        default_factory=list)


class _Run:
    """One run's context, given to every op handler: the device, host
    reads and uploads (with the runner's caches of constants) and the
    run's statistics."""

    def __init__(self, runner: "TorchGraphRunner"):
        self.runner = runner
        self.device = runner.device
        self.op = ""
        self.stats = RunStats()
        # id -> (numpy, tensor) / (tensor, numpy): the pairs keep both
        # objects alive, so an id is never reused within the run
        self._uploads: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._mirror: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}

    def feed(self, arr: np.ndarray):
        """A feed: a small integer one stays on the host, any other goes
        to the device, its host copy kept for reads."""
        if _host_ok(arr):
            return arr
        t = self.upload(arr)
        self._mirror[id(t)] = (t, arr)
        return t

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        self.stats.uploads += 1
        return _to_tensor(arr, self.device)

    def tensor(self, v) -> torch.Tensor:
        """``v`` on the device: a host value is copied once a run, a
        constant's once for the runner."""
        if isinstance(v, torch.Tensor):
            return v
        runner = self.runner
        hit = runner._uploads.get(id(v)) or self._uploads.get(id(v))
        if hit is not None:
            return hit[1]
        t = self.upload(v)
        if id(v) in runner._persistent:
            runner._uploads[id(v)] = (v, t)
        else:
            self._uploads[id(v)] = (v, t)
        return t

    def host(self, v) -> np.ndarray:
        """``v`` on the host; reading a device value without a host copy
        waits for the device and is counted under the current op."""
        if not isinstance(v, torch.Tensor):
            return np.asarray(v)
        hit = self.runner._mirror.get(id(v)) or self._mirror.get(id(v))
        if hit is not None:
            return hit[1]
        self.stats.reads[self.op] += 1
        return v.detach().cpu().numpy()

    def ints(self, v) -> List[int]:
        return [int(x) for x in self.host(v).reshape(-1)]

    def record(self, node: OnnxNode, env: Dict[str, Any]) -> None:
        stats = self.stats
        stats.nodes += 1
        on_host = False
        for name in node.outputs:
            v = env.get(name) if name else None
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                stats.outputs[v.device.type] += 1
                continue
            on_host = True
            stats.outputs["host"] += 1
            stats.host_outputs.append((node.op_type, node.name,
                                       str(v.dtype), int(v.size)))
        if on_host:
            stats.host_nodes[node.op_type] += 1


# ---------------------------------------------------------------------------
# Op lowerings: handler(cx, node, *args), args device tensors (or None),
# except the shape slots of _SHAPE_SLOTS, which hold host or device values
# read through cx.ints / cx.host. They mirror executor._OPS.
# ---------------------------------------------------------------------------


def _t_binary(fn):
    def handler(cx, node, a, b):
        return fn(a, b)

    return handler


def _t_unary(fn):
    def handler(cx, node, x):
        return fn(x)

    return handler


def _t_div(cx, node, a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.div(a, b)
    # ONNX integer Div truncates toward zero (executor._int_div)
    return torch.div(a, b, rounding_mode="trunc")


def _t_matmul(cx, node, a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.matmul(a, b)
    # CUDA has no integer matmul: float64 products of integers are exact
    # while the sums stay below 2**53
    out = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.double(), b.double()).to(out)


def _t_variadic(fn, xs):
    if not xs:
        raise ValueError("variadic op needs at least one input")
    out = xs[0]
    for x in xs[1:]:
        out = fn(out, x)
    return out


def _t_mean_of(xs):
    xs = [x if x.is_floating_point() else x.double() for x in xs]
    return functools.reduce(torch.add, xs) / len(xs)


def _t_einsum(cx, node, *args):
    eq = _attr(node, "equation")
    if isinstance(eq, bytes):
        eq = eq.decode("utf-8")
    if all(a.is_floating_point() for a in args):
        return torch.einsum(eq, *args)
    out = functools.reduce(torch.promote_types, [a.dtype for a in args])
    return torch.einsum(eq, *[a.double() for a in args]).to(out)


def _t_flatten(cx, node, x):
    axis = _attr(node, "axis", 1)
    lead = int(np.prod(tuple(x.shape)[:axis]) or 1)
    return x.reshape(lead, -1)


def _t_softmax(cx, node, x):
    return torch.softmax(x, dim=_attr(node, "axis", -1)).to(torch.float32)


def _t_softmax_legacy(node, x, log: bool):
    """opset < 13: the input coerced to [prod(:axis), prod(axis:)], one
    softmax over the flattened trailing block (executor._softmax_legacy)."""
    axis = _attr(node, "axis", 1)
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(tuple(x.shape)[:axis], dtype=np.int64)) if axis else 1
    s = torch.softmax(x.reshape(lead, -1), dim=1)
    out = torch.log(s) if log else s
    return out.reshape(x.shape).to(torch.float32)


def _t_gemm(cx, node, a, b, c=None):
    alpha = _attr(node, "alpha", 1.0)
    beta = _attr(node, "beta", 1.0)
    if _attr(node, "transA", 0):
        a = a.T
    if _attr(node, "transB", 0):
        b = b.T
    out = alpha * (a @ b)
    if c is not None:
        out = out + beta * c
    return out.to(torch.float32)


def _pad_list(pads: Sequence[int], spatial: int) -> List[int]:
    """ONNX [begin..., end...] -> F.pad's last-axis-first pairs."""
    return [p for i in reversed(range(spatial))
            for p in (pads[i], pads[i + spatial])]


_CONVS = (F.conv1d, F.conv2d, F.conv3d)
_CONV_TRANSPOSES = (F.conv_transpose1d, F.conv_transpose2d,
                    F.conv_transpose3d)


def _t_conv(cx, node, x, w, b=None):
    group = _attr(node, "group", 1)
    spatial = x.ndim - 2
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    pads = _conv_pad_list(node, tuple(x.shape), tuple(w.shape[2:]), strides,
                          dilations, spatial)
    x = x.float()
    if pads[:spatial] == pads[spatial:]:
        padding = tuple(pads[:spatial])
    else:
        x = F.pad(x, _pad_list(pads, spatial))
        padding = 0
    return _CONVS[spatial - 1](x, w.float(), None if b is None else b.float(),
                               stride=strides, padding=padding,
                               dilation=dilations, groups=group)


def _t_conv_transpose(cx, node, x, w, b=None):
    """The full transposed conv, then ``pads`` cropped from each end of
    each axis (executor._op_conv_transpose)."""
    spatial = x.ndim - 2
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    out_pad = tuple(_attr(node, "output_padding", [0] * spatial))
    pads = list(_attr(node, "pads", [0] * (2 * spatial)))
    if _attr(node, "output_shape") is not None or _attr(
            node, "auto_pad", "NOTSET") not in ("NOTSET", b"NOTSET"):
        raise NotImplementedError(
            "ConvTranspose output_shape / auto_pad not supported")
    out = _CONV_TRANSPOSES[spatial - 1](
        x.float(), w.float(), None if b is None else b.float(),
        stride=strides, output_padding=out_pad,
        groups=_attr(node, "group", 1), dilation=dilations)
    crop = (slice(None), slice(None)) + tuple(
        slice(pads[i], out.shape[2 + i] - pads[i + spatial])
        for i in range(spatial))
    return out[crop]


def _t_reshape(cx, node, data, shape):
    target = cx.ints(shape)
    return data.reshape([data.shape[i] if s == 0 else s
                         for i, s in enumerate(target)])


def _slice_axis(x: torch.Tensor, axis: int, start: int, end: int,
                step: int) -> torch.Tensor:
    """Python slicing of one axis, negative steps included (torch refuses
    them in an index)."""
    start, stop, step = slice(start, end, step).indices(x.shape[axis])
    if step > 0:
        index = [slice(None)] * x.ndim
        index[axis] = slice(start, stop, step)
        return x[tuple(index)]
    taken = range(start, stop, step)
    if not taken:
        return x.narrow(axis, 0, 0)
    out = x.narrow(axis, taken[-1], taken[0] - taken[-1] + 1).flip(axis)
    if step < -1:
        index = [slice(None)] * x.ndim
        index[axis] = slice(None, None, -step)
        out = out[tuple(index)]
    return out


def _t_slice(cx, node, data, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset < 10: attributes
        starts = _attr(node, "starts")
        ends = _attr(node, "ends")
        axes = _attr(node, "axes")
        steps = None
    starts = cx.ints(starts)
    ends = cx.ints(ends)
    axes = list(range(len(starts))) if axes is None else cx.ints(axes)
    steps = [1] * len(starts) if steps is None else cx.ints(steps)
    out = data
    for start, end, axis, step in zip(starts, ends, axes, steps):
        out = _slice_axis(out, axis % data.ndim, start, end, step)
    return out


def _t_concat(cx, node, *parts):
    return torch.cat([p for p in parts if p is not None],
                     dim=_attr(node, "axis", 0))


def _norm_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices count from the end; then clamped to the axis, as
    the JAX runner's ``mode="clip"`` does (an index past the axis would
    fault the device)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, max(n - 1, 0))


def _t_gather(cx, node, data, indices):
    axis = _attr(node, "axis", 0) % data.ndim
    shape = tuple(data.shape)
    idx = _norm_index(indices, shape[axis])
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(shape[:axis] + tuple(idx.shape) + shape[axis + 1:])


def _t_gather_elements(cx, node, data, indices):
    axis = _attr(node, "axis", 0) % data.ndim
    return torch.gather(data, axis, _norm_index(indices, data.shape[axis]))


def _axes(cx, node, axes_in):
    return ex._axes_arg(node, None if axes_in is None else cx.host(axes_in))


def _t_unsqueeze(cx, node, data, axes_in=None):
    out = data
    for axis in sorted(_axes(cx, node, axes_in)):
        out = out.unsqueeze(axis)
    return out


def _t_squeeze(cx, node, data, axes_in=None):
    axes = _axes(cx, node, axes_in)
    if axes is None:
        return data.squeeze()
    return data.squeeze(tuple(axes))


def _t_transpose(cx, node, data):
    perm = _attr(node, "perm")
    if perm is None:
        perm = list(reversed(range(data.ndim)))
    return data.permute(*perm)


def _t_cast(cx, node, x):
    return x.to(_torch_dtype(ex._DTYPE_BY_ONNX[int(_attr(node, "to"))]))


def _t_constant_of_shape(cx, node, shape):
    value = _attr(node, "value")
    shape = cx.ints(shape)
    if value is None:
        return torch.zeros(shape, dtype=torch.float32, device=cx.device)
    value = np.asarray(value)
    return torch.full(shape, value.reshape(-1)[0].item(),
                      dtype=_torch_dtype(value.dtype), device=cx.device)


def _t_expand(cx, node, data, shape):
    out = torch.broadcast_shapes(tuple(data.shape), tuple(cx.ints(shape)))
    return data.expand(out)


def _t_range(cx, node, start, limit, delta):
    # the interpreter's np.arange over Python scalars: int64 for
    # integers, float64 otherwise
    vals = [cx.host(v).reshape(()).item() for v in (start, limit, delta)]
    dtype = (torch.int64 if all(isinstance(v, int) for v in vals)
             else torch.float64)
    return torch.arange(*vals, dtype=dtype, device=cx.device)


def _t_tile(cx, node, data, repeats):
    return torch.tile(data, tuple(cx.ints(repeats)))


def _t_cumsum(cx, node, x, axis):
    axis = cx.ints(axis)[0] % max(x.ndim, 1)
    exclusive = int(_attr(node, "exclusive", 0))
    reverse = int(_attr(node, "reverse", 0))
    if reverse:
        x = x.flip(axis)
    out = torch.cumsum(x, dim=axis)
    if exclusive:
        n = out.shape[axis]
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, min(n, 1))),
                         out.narrow(axis, 0, max(n - 1, 0))], dim=axis)
    if reverse:
        out = out.flip(axis)
    return out


def _t_arg_extremum(fn):
    def handler(cx, node, data):
        axis = _attr(node, "axis", 0) % data.ndim
        keepdims = bool(_attr(node, "keepdims", 1))
        if _attr(node, "select_last_index", 0):
            # ties resolve to the LAST occurrence: flip and mirror
            out = data.shape[axis] - 1 - fn(data.flip(axis), dim=axis)
        else:
            out = fn(data, dim=axis)
        if keepdims:
            out = out.unsqueeze(axis)
        return out.to(torch.int64)

    return handler


def _t_clip(cx, node, x, lo=None, hi=None):
    lo = _attr(node, "min") if lo is None else lo
    hi = _attr(node, "max") if hi is None else hi
    if lo is None and hi is None:
        return x  # legal identity Clip
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        # torch.clamp takes two tensors or two numbers, not one of each
        lo, hi = (None if v is None else torch.as_tensor(
            v, dtype=x.dtype, device=x.device) for v in (lo, hi))
    return torch.clamp(x, min=lo, max=hi)


def _t_split(cx, node, data, split=None):
    axis = _attr(node, "axis", 0)
    if split is None:
        split = _attr(node, "split")
    if split is None:
        num_outputs = _attr(node, "num_outputs", len(node.outputs))
        # opset-18: ceil-sized chunks, the LAST one holds the remainder
        dim = data.shape[axis]
        chunk = -(-dim // num_outputs)
        sizes = [chunk] * (num_outputs - 1)
        sizes.append(dim - chunk * (num_outputs - 1))
    else:
        sizes = cx.ints(split)
    return tuple(torch.split(data, sizes, dim=axis))


def _pad_index(n: int, lo: int, hi: int, mode: str,
               device: torch.device) -> torch.Tensor:
    """Source index of each output position of one padded axis, for the
    ``edge`` and ``reflect`` modes (numpy's: reflection without repeating
    the edge, periodic past one reflection)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    k = torch.remainder(i, period)
    return torch.where(k < n, k, period - k)


def _t_pad(cx, node, data, pads=None, value=None, axes=None):
    pads = _attr(node, "pads") if pads is None else pads
    pads = cx.ints(pads)
    mode = _attr(node, "mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    ndim = data.ndim
    if axes is not None:
        axis_list = [a % ndim for a in cx.ints(axes)]
        n = len(axis_list)
        pad_width = [(0, 0)] * ndim
        for j, axis in enumerate(axis_list):
            pad_width[axis] = (pads[j], pads[j + n])
    else:
        pad_width = [(pads[i], pads[i + ndim]) for i in range(ndim)]
    if any(lo < 0 or hi < 0 for lo, hi in pad_width):
        # negative pads CROP from that edge (ONNX spec)
        crops = tuple(slice(max(-lo, 0), dim - max(-hi, 0))
                      for (lo, hi), dim in zip(pad_width, data.shape))
        data = data[crops]
        pad_width = [(max(lo, 0), max(hi, 0)) for lo, hi in pad_width]
    if mode == "constant":
        constant = (float(cx.host(value).reshape(-1)[0])
                    if value is not None else 0.0)
        return F.pad(data, [p for lo_hi in reversed(pad_width)
                            for p in lo_hi], value=constant)
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    for axis, (lo, hi) in enumerate(pad_width):
        if lo or hi:
            data = torch.index_select(
                data, axis, _pad_index(data.shape[axis], lo, hi, mode,
                                       data.device))
    return data


def _t_reduce(kind: str):
    def handler(cx, node, data, axes_in=None):
        axes = _axes(cx, node, axes_in)
        if axes == () and not _attr(node, "noop_with_empty_axes", 0):
            axes = None  # an EMPTY axes tensor reduces over every axis
        keepdims = bool(_attr(node, "keepdims", 1))
        if kind == "mean" and not data.is_floating_point():
            data = data.double()  # numpy's mean of integers
        dims = (tuple(range(data.ndim)) if axes is None
                else tuple(sorted(a % data.ndim for a in axes)))
        if not dims:  # noop_with_empty_axes, or a 0-d input
            return (data.to(torch.int64) if kind in ("sum", "prod")
                    and not data.is_floating_point() else data)
        if kind == "prod":
            out = data
            for d in reversed(dims):
                out = torch.prod(out, d, keepdim=keepdims)
            return out
        fn = {"mean": torch.mean, "sum": torch.sum, "max": torch.amax,
              "min": torch.amin}[kind]
        return fn(data, dim=dims, keepdim=keepdims)

    return handler


def _t_layer_norm(cx, node, x, scale, bias=None):
    axis = _attr(node, "axis", -1) % x.ndim
    eps = _attr(node, "epsilon", 1e-5)
    shape = tuple(x.shape[axis:])
    if tuple(scale.shape) == shape and (bias is None
                                        or tuple(bias.shape) == shape):
        return F.layer_norm(x.float(), shape, scale.float(),
                            None if bias is None else bias.float(), eps)
    dims = tuple(range(axis, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, keepdim=True, unbiased=False)
    out = (x - mean) / torch.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out.to(torch.float32)


def _reverse_rows(arr: torch.Tensor, lens: Optional[torch.Tensor]):
    """Reverse each batch row's valid time prefix, layout [T, B, ...];
    rows past their length stay (an involution; executor._reverse_rows
    without a host loop)."""
    if lens is None:
        return arr.flip(0)
    t = torch.arange(arr.shape[0], device=arr.device)[:, None]
    lens = lens.long()[None, :]
    idx = torch.where(t < lens, lens - 1 - t, t)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (arr.ndim - 2))
    return torch.gather(arr, 0, idx.expand(arr.shape))


def _seq_lens(seq_lens) -> Optional[torch.Tensor]:
    """[B] lengths, or None when the input is absent or empty. Lengths
    equal to the time axis take the masked path too, which gives the
    unmasked result, so the lengths are never read."""
    if seq_lens is None or seq_lens.numel() == 0:
        return None
    return seq_lens.reshape(-1).long()


def _rnn_dirs(direction: str) -> List[Tuple[int, bool]]:
    """(weight index, reverse) of each direction, in output order."""
    out = []
    if direction in ("forward", "bidirectional"):
        out.append((0, False))
    if direction in ("reverse", "bidirectional"):
        out.append((0 if direction == "reverse" else 1, True))
    return out


def _t_lstm(cx, node, x, w, r, b=None, seq_lens=None, h0=None, c0=None,
            p=None):
    """LSTM, gates iofc, layout [T, B, I], a time loop of torch ops with
    the interpreter's masked ``sequence_lens`` semantics."""
    _guard_rnn_attrs(node, 3)
    lens = _seq_lens(seq_lens)
    if p is not None and p.numel():
        raise NotImplementedError("LSTM peephole weights not supported")
    hidden = int(_attr(node, "hidden_size"))
    t_len, batch, _ = x.shape
    x = x.float()

    def run_dir(d, reverse):
        wd, rd = w[d].float(), r[d].float()
        bd = (b[d].float() if b is not None
              else torch.zeros(8 * hidden, device=x.device))
        wb, rb = bd[:4 * hidden], bd[4 * hidden:]
        h = (h0[d].float() if h0 is not None
             else torch.zeros((batch, hidden), device=x.device))
        c = (c0[d].float() if c0 is not None
             else torch.zeros((batch, hidden), device=x.device))
        xs = _reverse_rows(x, lens) if reverse else x
        gx = xs @ wd.T + wb
        outs = []
        for t in range(t_len):
            gates = gx[t] + h @ rd.T + rb
            i = torch.sigmoid(gates[:, :hidden])
            o = torch.sigmoid(gates[:, hidden:2 * hidden])
            f = torch.sigmoid(gates[:, 2 * hidden:3 * hidden])
            g = torch.tanh(gates[:, 3 * hidden:])
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            if lens is None:
                h, c = h_new, c_new
                outs.append(h_new)
            else:
                mask = (t < lens)[:, None]
                h = torch.where(mask, h_new, h)
                c = torch.where(mask, c_new, c)
                outs.append(torch.where(mask, h_new, 0.0))
        y = torch.stack(outs) if outs else x.new_zeros((0, batch, hidden))
        if reverse:
            y = _reverse_rows(y, lens)
        return y, h, c

    results = [run_dir(d, rev)
               for d, rev in _rnn_dirs(_attr(node, "direction", "forward"))]
    return (torch.stack([res[0] for res in results], dim=1),
            torch.stack([res[1] for res in results]),
            torch.stack([res[2] for res in results]))


def _t_gru(cx, node, x, w, r, b=None, seq_lens=None, h0=None):
    """GRU, gates zrh (masked semantics as in :func:`_t_lstm`)."""
    _guard_rnn_attrs(node, 2)
    lens = _seq_lens(seq_lens)
    hidden = int(_attr(node, "hidden_size"))
    linear_before_reset = _attr(node, "linear_before_reset", 0)
    t_len, batch, _ = x.shape
    x = x.float()

    def run_dir(d, reverse):
        wd, rd = w[d].float(), r[d].float()
        bd = (b[d].float() if b is not None
              else torch.zeros(6 * hidden, device=x.device))
        wb, rb = bd[:3 * hidden], bd[3 * hidden:]
        h = (h0[d].float() if h0 is not None
             else torch.zeros((batch, hidden), device=x.device))
        xs = _reverse_rows(x, lens) if reverse else x
        gx_all = xs @ wd.T + wb
        outs = []
        for t in range(t_len):
            gx = gx_all[t]
            gh = h @ rd.T + rb
            z = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
            rr = torch.sigmoid(gx[:, hidden:2 * hidden]
                               + gh[:, hidden:2 * hidden])
            if linear_before_reset:
                n = torch.tanh(gx[:, 2 * hidden:] + rr * gh[:, 2 * hidden:])
            else:
                n = torch.tanh(gx[:, 2 * hidden:]
                               + (rr * h) @ rd[2 * hidden:].T
                               + rb[2 * hidden:])
            h_new = (1 - z) * n + z * h
            if lens is None:
                h = h_new
                outs.append(h_new)
            else:
                mask = (t < lens)[:, None]
                h = torch.where(mask, h_new, h)
                outs.append(torch.where(mask, h_new, 0.0))
        y = torch.stack(outs) if outs else x.new_zeros((0, batch, hidden))
        if reverse:
            y = _reverse_rows(y, lens)
        return y, h

    results = [run_dir(d, rev)
               for d, rev in _rnn_dirs(_attr(node, "direction", "forward"))]
    return (torch.stack([res[0] for res in results], dim=1),
            torch.stack([res[1] for res in results]))


# -- quantized ops: bit-exact with the interpreter ---------------------------


def _per_axis(a: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """Scale/zero-point broadcast: a scalar stays scalar; 1-D maps to
    ``axis`` (executor._per_axis)."""
    if a.ndim == 0 or a.numel() == 1:
        return a.reshape(())
    shape = [1] * ndim
    shape[axis] = a.numel()
    return a.reshape(shape)


def _saturate(values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    info = torch.iinfo(dtype)
    return torch.clamp(values, info.min, info.max).to(dtype)


def _t_quantize_linear(cx, node, x, scale, zp=None):
    axis = _attr(node, "axis", 1)
    s = _per_axis(scale, x.ndim, axis)
    dtype = zp.dtype if zp is not None else torch.uint8
    z = (_per_axis(zp, x.ndim, axis).to(torch.int32) if zp is not None
         else 0)
    return _saturate(torch.round(x / s).to(torch.int32) + z, dtype)


def _t_dequantize_linear(cx, node, x, scale, zp=None):
    axis = _attr(node, "axis", 1)
    s = _per_axis(scale, x.ndim, axis).to(torch.float32)
    z = (_per_axis(zp, x.ndim, axis).to(torch.int32) if zp is not None
         else 0)
    # an int8 step times a float32 scale is one correctly rounded f32
    # product, as the interpreter's float64 product rounded to f32
    return ((x.to(torch.int32) - z) * s).to(torch.float32)


def _t_dynamic_quantize_linear(cx, node, x):
    # every step in float32, per the ONNX spec (executor's handler)
    x = x.float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.numel():
        rmin = torch.minimum(x.min(), zero)
        rmax = torch.maximum(x.max(), zero)
    else:
        rmin = rmax = zero
    scale = (rmax - rmin) / 255.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(zero - rmin / scale), 0, 255).to(
        torch.uint8)
    y = _saturate(torch.round(x / scale).to(torch.int32)
                  + zp.to(torch.int32), torch.uint8)
    return y, scale, zp


def _sub_zp(v: torch.Tensor, zp, shape_fn) -> torch.Tensor:
    if zp is None:
        return v
    z = zp.to(torch.float64)
    return v - (shape_fn(z) if z.ndim == 1 and z.numel() > 1 else z)


def _int_matmul(a, b, a_zp=None, b_zp=None) -> torch.Tensor:
    """Exact (A - a_zp) @ (B - b_zp) as int32: float64 products of int8
    values, exact sums below 2**53 (executor._int_matmul's int64)."""
    a64 = _sub_zp(a.to(torch.float64), a_zp, lambda z: z.reshape(-1, 1))
    b64 = _sub_zp(b.to(torch.float64), b_zp, lambda z: z.reshape(1, -1))
    return torch.matmul(a64, b64).to(torch.int32)


def _t_matmul_integer(cx, node, a, b, a_zp=None, b_zp=None):
    return _int_matmul(a, b, a_zp, b_zp)


def _t_qlinear_matmul(cx, node, a, a_scale, a_zp, b, b_scale, b_zp,
                      y_scale, y_zp):
    acc = _int_matmul(a, b, a_zp, b_zp).to(torch.float32)
    scale = a_scale.float() * b_scale.float() / y_scale.float()
    y = torch.round(acc * scale).to(torch.int64) + y_zp.to(torch.int64)
    return _saturate(y, y_zp.dtype)


def _int_conv(node, x, w, x_zp=None, w_zp=None) -> torch.Tensor:
    """Exact integer conv (1D/2D, groups) as float64 of integer values:
    im2col, then a float64 product per group (executor._int_conv_exact)."""
    spatial = x.ndim - 2
    group = _attr(node, "group", 1)
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    pads = _conv_pad_list(node, tuple(x.shape), tuple(w.shape[2:]), strides,
                          dilations, spatial)
    x64 = x.to(torch.float64)
    if x_zp is not None:
        x64 = x64 - x_zp.to(torch.float64)  # scalar per spec
    w64 = _sub_zp(w.to(torch.float64), w_zp,
                  lambda z: z.reshape((-1,) + (1,) * (w.ndim - 1)))
    if spatial == 1:
        x64, w64 = x64[..., None], w64[..., None]
        strides, dilations = strides + (1,), dilations + (1,)
        pads = [pads[0], 0, pads[1], 0]
    xp = F.pad(x64, (pads[1], pads[3], pads[0], pads[2]))
    n, _, h, wd = xp.shape
    c_out, c_in_g, kh, kw = w64.shape
    oh = (h - (kh - 1) * dilations[0] - 1) // strides[0] + 1
    ow = (wd - (kw - 1) * dilations[1] - 1) // strides[1] + 1
    cols = F.unfold(xp, (kh, kw), dilation=dilations, stride=strides)
    cols = cols.reshape(n, group, c_in_g * kh * kw, oh * ow)
    w2 = w64.reshape(group, c_out // group, c_in_g * kh * kw)
    out = torch.matmul(w2, cols).reshape(n, c_out, oh, ow)
    return out[..., 0] if spatial == 1 else out


def _t_conv_integer(cx, node, x, w, x_zp=None, w_zp=None):
    return _int_conv(node, x, w, x_zp, w_zp).to(torch.int32)


def _t_qlinear_conv(cx, node, x, x_scale, x_zp, w, w_scale, w_zp,
                    y_scale, y_zp, b=None):
    acc = _int_conv(node, x, w, x_zp, w_zp)
    if b is not None:  # int32 bias at scale x_scale*w_scale
        acc = acc + b.to(torch.float64).reshape((1, -1)
                                                + (1,) * (acc.ndim - 2))
    # f32 single-rounding requant (an exact integer below 2**53 rounds to
    # float32 as the interpreter's int64 does)
    scale = x_scale.float() * w_scale.float() / y_scale.float()
    s = _per_axis(scale, acc.ndim, 1)
    y = (torch.round(acc.to(torch.float32) * s).to(torch.int64)
         + y_zp.to(torch.int64))
    return _saturate(y, y_zp.dtype)


# -- scatter / gather families, TopK, OneHot, sequence reversal -------------


def _t_scatter_nd(cx, node, data, indices, updates):
    red = _attr(node, "reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    k = indices.shape[-1]
    shape = tuple(data.shape)
    idx = indices.long()
    dims = torch.tensor(shape[:k], dtype=torch.int64, device=idx.device)
    idx = torch.where(idx < 0, idx + dims, idx)
    # row-major linear index over the first k axes
    strides = torch.tensor([int(np.prod(shape[i + 1:k])) for i in range(k)],
                           dtype=torch.int64, device=idx.device)
    lin = (idx * strides).sum(-1).reshape(-1)
    out = data.clone().reshape((-1,) + shape[k:])
    upd = updates.to(data.dtype).reshape((-1,) + shape[k:])
    if red == "none":
        out.index_copy_(0, lin, upd)
    elif red == "add":
        out.index_add_(0, lin, upd)
    else:
        out.index_reduce_(0, lin, upd, {"mul": "prod", "max": "amax",
                                        "min": "amin"}[red])
    return out.reshape(shape)


def _t_scatter_elements(cx, node, data, indices, updates):
    axis = _attr(node, "axis", 0) % data.ndim
    red = _attr(node, "reduction", "none")
    if isinstance(red, bytes):
        red = red.decode()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    upd = updates.to(data.dtype)
    if red == "none":
        return data.scatter(axis, idx, upd)
    return data.scatter_reduce(axis, idx, upd,
                               {"add": "sum", "mul": "prod", "max": "amax",
                                "min": "amin"}[red], include_self=True)


def _t_gather_nd(cx, node, data, indices):
    batch_dims = _attr(node, "batch_dims", 0)
    idx = indices.long()
    last = idx.shape[-1]
    dims = torch.tensor(tuple(data.shape[batch_dims:batch_dims + last]),
                        dtype=torch.int64, device=idx.device)
    idx = torch.where(idx < 0, idx + dims, idx)
    if not batch_dims:
        return data[tuple(idx.movedim(-1, 0))]
    # fold the leading batch dims into an extra index column
    bshape = tuple(data.shape[:batch_dims])
    d2 = data.reshape((-1,) + tuple(data.shape[batch_dims:]))
    i2 = idx.reshape((-1,) + tuple(idx.shape[batch_dims:]))
    rows = torch.arange(d2.shape[0], device=idx.device).reshape(
        (-1,) + (1,) * (i2.ndim - 1))
    rows = rows.expand(tuple(i2.shape[:-1]) + (1,))
    i3 = torch.cat([rows, i2], dim=-1)
    out = d2[tuple(i3.movedim(-1, 0))]
    return out.reshape(bshape + tuple(out.shape[1:]))


def _t_nonzero(cx, node, x):
    # the count of nonzeros sizes the output: torch reads it on the host
    cx.stats.reads[cx.op] += 1
    return torch.stack(torch.nonzero(x, as_tuple=True)).to(torch.int64)


def _t_topk(cx, node, x, k):
    axis = _attr(node, "axis", -1)
    largest = _attr(node, "largest", 1)
    k = cx.ints(k)[0]
    # a stable sort: ties keep the lower index first
    _, order = torch.sort(x, dim=axis, descending=bool(largest),
                          stable=True)
    idx = order.narrow(axis % x.ndim, 0, k)
    return torch.gather(x, axis, idx), idx.to(torch.int64)


def _t_one_hot(cx, node, indices, depth, values):
    axis = _attr(node, "axis", -1)
    depth = cx.ints(depth)[0]
    off_on = values.reshape(-1)
    idx = indices.long()
    idx = torch.where(idx < 0, idx + depth, idx)
    hot = idx[..., None] == torch.arange(depth, device=idx.device)
    out = torch.where(hot, off_on[1], off_on[0]).to(off_on.dtype)
    dest = axis if axis >= 0 else out.ndim + axis
    return out.movedim(-1, dest)


def _t_reverse_sequence(cx, node, x, sequence_lens):
    batch_axis = _attr(node, "batch_axis", 1)
    time_axis = _attr(node, "time_axis", 0)
    xm = x.movedim((time_axis, batch_axis), (0, 1))
    out = _reverse_rows(xm, sequence_lens.reshape(-1))
    return out.movedim((0, 1), (time_axis, batch_axis))


def _t_trilu(cx, node, x, k=None):
    kk = cx.ints(k)[0] if k is not None else 0
    return torch.triu(x, kk) if _attr(node, "upper", 1) else torch.tril(x, kk)


def _t_reciprocal(cx, node, x):
    if x.dtype == torch.float32:
        return torch.reciprocal(x)
    return 1.0 / x.double() if not x.is_floating_point() else 1.0 / x


def _t_shape(cx, node, x):
    return np.asarray(tuple(x.shape), np.int64)


def _t_size(cx, node, x):
    return np.asarray(x.numel(), np.int64)


def _t_constant(cx, node):
    return cx.runner._constant(node)


def _t_elu(cx, node, x):
    return torch.where(x > 0, x, _attr(node, "alpha", 1.0)
                       * (torch.exp(x) - 1))


def _t_selu(cx, node, x):
    return _attr(node, "gamma", 1.0507009873554805) * torch.where(
        x > 0, x, _attr(node, "alpha", 1.6732632423543772)
        * (torch.exp(x) - 1))


_TORCH_OPS: Dict[str, Any] = {
    "Add": _t_binary(torch.add),
    "Sub": _t_binary(torch.sub),
    "Mul": _t_binary(torch.mul),
    "Div": _t_div,
    "Pow": _t_binary(torch.pow),
    "MatMul": _t_matmul,
    "And": _t_binary(torch.logical_and),
    "Or": _t_binary(torch.logical_or),
    "Xor": _t_binary(torch.logical_xor),
    "Equal": _t_binary(torch.eq),
    "Greater": _t_binary(torch.gt),
    "GreaterOrEqual": _t_binary(torch.ge),
    "Less": _t_binary(torch.lt),
    "LessOrEqual": _t_binary(torch.le),
    # variadic (1..N inputs) per spec
    "Min": lambda cx, node, *xs: _t_variadic(torch.minimum, xs),
    "Max": lambda cx, node, *xs: _t_variadic(torch.maximum, xs),
    "Sum": lambda cx, node, *xs: _t_variadic(torch.add, xs),
    "Mean": lambda cx, node, *xs: _t_mean_of(xs),
    "Relu": _t_unary(torch.relu),
    "Sigmoid": _t_unary(torch.sigmoid),
    "Tanh": _t_unary(torch.tanh),
    "Erf": _t_unary(torch.special.erf),
    "Exp": _t_unary(torch.exp),
    "Log": _t_unary(torch.log),
    "Sqrt": _t_unary(torch.sqrt),
    "Neg": _t_unary(torch.neg),
    "Abs": _t_unary(torch.abs),
    "Sin": _t_unary(torch.sin),
    "Cos": _t_unary(torch.cos),
    "Floor": _t_unary(torch.floor),
    "Ceil": _t_unary(torch.ceil),
    "Round": _t_unary(torch.round),  # half to even, like ONNX
    "Sign": _t_unary(torch.sign),
    "Not": _t_unary(torch.logical_not),
    "IsNaN": _t_unary(torch.isnan),
    "IsInf": _t_unary(torch.isinf),
    "Identity": lambda cx, node, x: x,
    "Dropout": lambda cx, node, x, *rest: x,
    "Mod": lambda cx, node, a, b: (torch.fmod(a, b) if _attr(node, "fmod", 0)
                                   else torch.remainder(a, b)),
    "Einsum": _t_einsum,
    "Reciprocal": _t_reciprocal,
    "HardSigmoid": lambda cx, node, x: torch.clamp(
        _attr(node, "alpha", 0.2) * x + _attr(node, "beta", 0.5), 0, 1),
    "Elu": _t_elu,
    "Selu": _t_selu,
    "LeakyRelu": lambda cx, node, x: torch.where(
        x >= 0, x, x * _attr(node, "alpha", 0.01)).to(torch.float32),
    "Softplus": lambda cx, node, x: torch.logaddexp(
        torch.zeros_like(x), x).to(torch.float32),
    "Softmax": _t_softmax,
    "LogSoftmax": lambda cx, node, x: torch.log(_t_softmax(cx, node, x)),
    "Shape": _t_shape,
    "Size": _t_size,
    "Flatten": _t_flatten,
    "Gemm": _t_gemm,
    "Conv": _t_conv,
    "ConvTranspose": _t_conv_transpose,
    "Reshape": _t_reshape,
    "Slice": _t_slice,
    "Concat": _t_concat,
    "Gather": _t_gather,
    "GatherElements": _t_gather_elements,
    "Unsqueeze": _t_unsqueeze,
    "Squeeze": _t_squeeze,
    "Transpose": _t_transpose,
    "Cast": _t_cast,
    "Constant": _t_constant,
    "ConstantOfShape": _t_constant_of_shape,
    "Expand": _t_expand,
    "Where": lambda cx, node, cond, a, b: torch.where(cond.bool(), a, b),
    "Range": _t_range,
    "Tile": _t_tile,
    "CumSum": _t_cumsum,
    "ArgMax": _t_arg_extremum(torch.argmax),
    "ArgMin": _t_arg_extremum(torch.argmin),
    "Clip": _t_clip,
    "Split": _t_split,
    "Pad": _t_pad,
    "ReduceMean": _t_reduce("mean"),
    "ReduceSum": _t_reduce("sum"),
    "ReduceMax": _t_reduce("max"),
    "ReduceMin": _t_reduce("min"),
    "ReduceProd": _t_reduce("prod"),
    "LayerNormalization": _t_layer_norm,
    "LSTM": _t_lstm,
    "GRU": _t_gru,
    "QuantizeLinear": _t_quantize_linear,
    "DequantizeLinear": _t_dequantize_linear,
    "DynamicQuantizeLinear": _t_dynamic_quantize_linear,
    "MatMulInteger": _t_matmul_integer,
    "QLinearMatMul": _t_qlinear_matmul,
    "ConvInteger": _t_conv_integer,
    "QLinearConv": _t_qlinear_conv,
    "ScatterND": _t_scatter_nd,
    "ScatterElements": _t_scatter_elements,
    "GatherND": _t_gather_nd,
    "NonZero": _t_nonzero,
    "TopK": _t_topk,
    "OneHot": _t_one_hot,
    "ReverseSequence": _t_reverse_sequence,
    "Trilu": _t_trilu,
}

# ops the runner dispatches itself, as the interpreter does (executor.py
# OnnxExecutor._exec_nodes), besides the pre-13 Softmax/LogSoftmax
CONTROL_OPS = ("If", "Loop", "RandomNormalLike")

# input positions whose values are read on the host (shapes, bounds,
# counts, axes): they reach the handler as host or device values
_SHAPE_SLOTS: Dict[str, Tuple[int, ...]] = {
    "Reshape": (1,),
    "Expand": (1,),
    "Tile": (1,),
    "Slice": (1, 2, 3, 4),
    "Pad": (1, 2, 3),
    "Unsqueeze": (1,),
    "Squeeze": (1,),
    "Split": (1,),
    "TopK": (1,),
    "OneHot": (1,),
    "CumSum": (1,),
    "Trilu": (1,),
    "Range": (0, 1, 2),
    "ConstantOfShape": (0,),
    "ReduceMean": (1,),
    "ReduceSum": (1,),
    "ReduceMax": (1,),
    "ReduceMin": (1,),
    "ReduceProd": (1,),
    # their input's shape alone
    "Shape": (0,),
    "Size": (0,),
}


class TorchGraphRunner:
    """Run an ONNX graph op by op on a torch device.

    Drop-in for :meth:`OnnxExecutor.run`: ``run(feeds, outputs=None)``
    returns numpy arrays. ``executor`` is the interpreter whose numpy RNG
    draws the graph's noise (``runner.executor.reseed(seed)``).
    ``last_run`` holds the :class:`RunStats` of the latest run.

    device: None means the GPU (and raises without one); ``"cpu"`` runs
    the same ops on the host's torch. matmul_precision: the engine's
    values (:func:`phoonnx_tpu_torch.infer.engine._prec_scope`).
    """

    def __init__(self, model: OnnxModel, device=None,
                 matmul_precision: Optional[str] = None):
        self.model = model
        self.device = resolve_device(device)
        self.executor = OnnxExecutor(model)
        self.matmul_precision = matmul_precision
        self.last_run: Optional[RunStats] = None
        # persistent values: host arrays (their ids, and their device
        # copies once a device op takes them) and host copies of small
        # device constants
        self._persistent: set = set()
        self._uploads: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._mirror: Dict[int, Tuple[torch.Tensor, np.ndarray]] = {}
        self._constants: Dict[int, Any] = {}
        self._inits = self._place(model.initializers)
        self._sub_inits: Dict[int, Dict[str, Any]] = {}
        self._place_subgraphs(model)

    # -- constants -----------------------------------------------------

    def _persist(self, arr: np.ndarray):
        """A constant's value: small integers stay on the host, the rest
        goes to the device once (a small one keeps its host copy)."""
        arr = np.asarray(arr)
        if _host_ok(arr):
            self._persistent.add(id(arr))
            return arr
        t = _to_tensor(arr, self.device)
        if arr.size <= HOST_MAX:
            self._mirror[id(t)] = (t, arr)
        return t

    def _place(self, initializers: Dict[str, np.ndarray]) -> Dict[str, Any]:
        return {name: self._persist(arr)
                for name, arr in initializers.items()}

    def _place_subgraphs(self, graph: OnnxModel) -> None:
        for node in graph.nodes:
            for sub in node.attributes.values():
                if isinstance(sub, OnnxModel):
                    self._sub_inits[id(sub)] = self._place(sub.initializers)
                    self._place_subgraphs(sub)

    def _constant(self, node: OnnxNode):
        value = self._constants.get(id(node))
        if value is None:
            value = self._persist(ex._op_constant(node))
            self._constants[id(node)] = value
        return value

    # -- running -------------------------------------------------------

    def run(self, feeds: Dict[str, np.ndarray],
            outputs: Optional[Sequence[str]] = None) -> List[np.ndarray]:
        cx = _Run(self)
        env: Dict[str, Any] = dict(self._inits)
        with _prec_scope(self.matmul_precision), torch.inference_mode():
            env.update({k: cx.feed(np.asarray(v)) for k, v in feeds.items()})
            env[""] = None  # optional (empty-name) inputs
            self._exec_nodes(self.model.nodes, env, cx)
            wanted = outputs or self.model.outputs
            results = [env[name].detach().cpu().numpy()
                       if isinstance(env[name], torch.Tensor)
                       else np.asarray(env[name]) for name in wanted]
        self.last_run = cx.stats
        return results

    def _exec_nodes(self, nodes, env: Dict[str, Any], cx: _Run) -> None:
        for node in nodes:
            op = node.op_type
            cx.op = op
            if op == "If":
                self._exec_if(node, env, cx)
            elif op == "Loop":
                self._exec_loop(node, env, cx)
            elif op == "RandomNormalLike":
                x = env.get(node.inputs[0])
                env[node.outputs[0]] = cx.upload(
                    self.executor._random_normal_like(
                        node, _ShapeOnly(tuple(x.shape))))
            elif op in ("Softmax", "LogSoftmax") \
                    and 0 < self.model.opset < 13:
                env[node.outputs[0]] = _t_softmax_legacy(
                    node, cx.tensor(env.get(node.inputs[0])),
                    log=op == "LogSoftmax")
            else:
                handler = _TORCH_OPS.get(op)
                if handler is None:
                    raise NotImplementedError(
                        f"ONNX op '{op}' not supported (node {node.name})")
                args = [env.get(name) for name in node.inputs]
                result = self._on_host(node, args)
                if result is None:
                    slots = _SHAPE_SLOTS.get(op, ())
                    result = handler(cx, node, *[
                        a if a is None or i in slots else cx.tensor(a)
                        for i, a in enumerate(args)])
                if not isinstance(result, tuple):
                    result = (result,)
                for out_name, value in zip(node.outputs, result):
                    if out_name:
                        env[out_name] = value
            cx.record(node, env)

    @staticmethod
    def _on_host(node: OnnxNode, args: List[Any]):
        """The interpreter's numpy handler, when every input and output is
        a small host integer (shape arithmetic); else None."""
        op = node.op_type
        if op in ("Shape", "Size", "Constant"):
            return None  # their lowerings make host values themselves
        if not all(a is None or (isinstance(a, np.ndarray) and _host_ok(a))
                   for a in args):
            return None
        result = ex._OPS[op](node, *args)
        outs = tuple(np.asarray(o) for o in (
            result if isinstance(result, tuple) else (result,)))
        if not all(_host_ok(o) for o in outs):
            return None
        return outs if isinstance(result, tuple) else outs[0]

    # -- control flow ------------------------------------------------------

    def _subgraph_env(self, graph: OnnxModel,
                      env: Dict[str, Any]) -> Dict[str, Any]:
        # subgraphs capture the outer scope by name; a flat copy gives the
        # body read access without leaking its writes back
        child = dict(env)
        child.update(self._sub_inits[id(graph)])
        return child

    def _exec_if(self, node: OnnxNode, env: Dict[str, Any],
                 cx: _Run) -> None:
        cond = bool(cx.host(env[node.inputs[0]]).reshape(()))
        branch = node.attributes["then_branch" if cond else "else_branch"]
        child = self._subgraph_env(branch, env)
        self._exec_nodes(branch.nodes, child, cx)
        cx.op = "If"
        for out_name, g_out in zip(node.outputs, branch.outputs):
            if out_name:
                env[out_name] = child[g_out]

    def _exec_loop(self, node: OnnxNode, env: Dict[str, Any],
                   cx: _Run) -> None:
        """ONNX Loop: inputs [M, cond, v...]; body (iter, cond, v...) ->
        (cond, v..., scan...); outputs [v_final..., scan_stacked...]. The
        body runs on the device; its condition is read once a trip."""
        body = node.attributes["body"]
        m_name = node.inputs[0] if len(node.inputs) > 0 else ""
        cond_name = node.inputs[1] if len(node.inputs) > 1 else ""
        max_trip = (int(cx.host(env[m_name]).reshape(()))
                    if m_name and env.get(m_name) is not None else None)
        cond = (bool(cx.host(env[cond_name]).reshape(()))
                if cond_name and env.get(cond_name) is not None else True)
        carried = [env[name] for name in node.inputs[2:]]
        n_carried = len(carried)
        n_scan = len(body.outputs) - 1 - n_carried
        scans: List[List[Any]] = [[] for _ in range(n_scan)]
        if max_trip is None and not cond_name:
            raise ValueError(
                f"Loop node {node.name} has neither a trip count nor a "
                "condition — it would never terminate")

        def run_body(it: int, cond: bool, carried):
            child = self._subgraph_env(body, env)
            child[body.inputs[0]] = np.asarray(it, np.int64)
            child[body.inputs[1]] = np.asarray(cond)
            for name, val in zip(body.inputs[2:], carried):
                child[name] = val
            self._exec_nodes(body.nodes, child, cx)
            cx.op = "Loop"
            return child

        it = 0
        while cond and (max_trip is None or it < max_trip):
            child = run_body(it, cond, carried)
            cond = bool(cx.host(child[body.outputs[0]]).reshape(()))
            carried = [child[n] for n in body.outputs[1:1 + n_carried]]
            for i, n in enumerate(body.outputs[1 + n_carried:]):
                scans[i].append(child[n])
            it += 1
        outs = list(carried)
        if n_scan and not scans[0]:
            # zero trips: (0, *per-iteration shape) in the body's dtype,
            # from one probe of the (pure) body, as the interpreter does
            try:
                child = run_body(0, True, carried)
                outs.extend(
                    np.zeros((0,) + p.shape, p.dtype)
                    if isinstance(p, np.ndarray) else
                    p.new_zeros((0,) + tuple(p.shape))
                    for p in (child[n] for n in body.outputs[1 + n_carried:]))
            except Exception:  # un-probeable body: degrade to (0,) f32
                outs.extend([torch.zeros((0,), device=cx.device)] * n_scan)
        else:
            for s in scans:
                if all(isinstance(v, np.ndarray) for v in s):
                    stacked = np.stack(s)
                    outs.append(stacked if _host_ok(stacked)
                                else cx.tensor(stacked))
                else:
                    outs.append(torch.stack([cx.tensor(v) for v in s]))
        for out_name, value in zip(node.outputs, outs):
            if out_name:
                env[out_name] = value
