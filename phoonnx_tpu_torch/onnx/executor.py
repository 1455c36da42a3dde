"""Generic ONNX graph executor (numpy) for auxiliary models.

Executes the op subset used by the ecosystem's small ONNX models — the
tashkeel diacritizer, silero VAD (LSTM), ByT5/Charsiu G2P exports, and
mimic3/coqui voices — replacing the reference's onnxruntime dependency for
everything that is not the main VITS path (which runs natively on TPU).

Host-side eager numpy: these models are tiny and latency-bound, not
throughput-bound. Unsupported ops raise with the op name so coverage gaps
are explicit.

PyTorch port: a copy of ``phoonnx_tpu/onnx/executor.py`` in which the two
handlers that called JAX, ``_op_conv`` and ``_op_conv_transpose``, run
``torch.nn.functional`` on CPU tensors instead; every other function is
the original's (``tests/test_torch_host_copies.py``). It is the host
reference of :mod:`phoonnx_tpu_torch.onnx.torch_lowering` and the
``compile=False`` path of the fallback engine.
"""

import functools
import logging
import math

from scipy.special import erf as _erf
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from phoonnx_tpu_torch.onnx.reader import _DTYPES as _DTYPE_BY_ONNX
from phoonnx_tpu_torch.onnx.reader import OnnxModel, OnnxNode

LOG = logging.getLogger(__name__)

def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _norm_seq_lens(seq_lens, x) -> Optional[np.ndarray]:
    """Normalize an optional ``sequence_lens`` input to an int64 [B]
    array, or None when every row uses the full time dimension (the
    unmasked fast path)."""
    if seq_lens is None:
        return None
    lens = np.asarray(seq_lens).astype(np.int64).reshape(-1)
    if lens.size == 0 or np.all(lens == x.shape[0]):
        return None
    return lens


def _reverse_rows(arr: np.ndarray, lens: Optional[np.ndarray]) -> np.ndarray:
    """Reverse each batch row's valid time prefix in place-layout
    [T, B, ...]; padding rows (t >= lens[b]) stay put. With lens None
    the whole time axis flips. Involution: applying twice is identity."""
    if lens is None:
        return arr[::-1]
    out = np.array(arr, copy=True)
    for b, n in enumerate(lens):
        n = int(n)
        if n > 0:
            out[:n, b] = arr[n - 1:: -1, b]
    return out


def _int_div(a, b):
    """Integer division truncating toward zero (ONNX Div semantics;
    np.floor_divide rounds toward -inf, off by one for negatives)."""
    q = np.floor_divide(a, b)
    r = a - q * b
    return q + ((r != 0) & ((a < 0) != (b < 0)))


class OnnxExecutor:
    """Interpret an OnnxModel graph."""

    def __init__(self, model: OnnxModel):
        self.model = model
        self.initializers = dict(model.initializers)
        # instance RNG for Random* nodes that carry no 'seed' attribute;
        # reseed() makes a synthesis run reproducible (the reference's
        # onnxruntime path has no equivalent — graph-internal noise there
        # is never seedable, reference voice.py:350-377)
        self.rng = np.random.default_rng()

    def reseed(self, seed: Optional[int]) -> None:
        """Reset the instance RNG (None -> fresh OS entropy)."""
        self.rng = np.random.default_rng(seed)

    def run(self, feeds: Dict[str, np.ndarray],
            outputs: Optional[Sequence[str]] = None) -> List[np.ndarray]:
        env: Dict[str, Any] = dict(self.initializers)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        env[""] = None  # optional (empty-name) inputs

        self._exec_nodes(self.model.nodes, env)

        wanted = outputs or self.model.outputs
        return [env[name] for name in wanted]

    def _exec_nodes(self, nodes, env: Dict[str, Any]) -> None:
        for node in nodes:
            if node.op_type == "If":
                self._exec_if(node, env)
                continue
            if node.op_type == "Loop":
                self._exec_loop(node, env)
                continue
            if node.op_type == "RandomNormalLike":
                x = env.get(node.inputs[0])
                env[node.outputs[0]] = self._random_normal_like(node, x)
                continue
            if node.op_type in ("Softmax", "LogSoftmax") \
                    and 0 < self.model.opset < 13:
                # pre-13 semantics flatten the trailing block (needs the
                # MODEL opset, which op handlers don't see)
                x = env.get(node.inputs[0])
                env[node.outputs[0]] = _softmax_legacy(
                    node, x, log=node.op_type == "LogSoftmax")
                continue
            handler = _OPS.get(node.op_type)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op '{node.op_type}' not supported "
                    f"(node {node.name})"
                )
            args = [env.get(name) for name in node.inputs]
            result = handler(node, *args)
            if not isinstance(result, tuple):
                result = (result,)
            for out_name, value in zip(node.outputs, result):
                if out_name:
                    env[out_name] = value

    # -- control flow (subgraph attributes) ----------------------------

    def _subgraph_env(self, graph, env: Dict[str, Any]) -> Dict[str, Any]:
        # ONNX subgraphs capture the outer scope by name; a flat copy
        # gives the body read access without leaking its writes back
        child = dict(env)
        child.update(graph.initializers)
        return child

    def _exec_if(self, node, env: Dict[str, Any]) -> None:
        cond = bool(np.asarray(env[node.inputs[0]]).reshape(()))
        branch = node.attributes["then_branch" if cond else "else_branch"]
        child = self._subgraph_env(branch, env)
        self._exec_nodes(branch.nodes, child)
        for out_name, g_out in zip(node.outputs, branch.outputs):
            if out_name:
                env[out_name] = child[g_out]

    def _random_normal_like(self, node, x) -> np.ndarray:
        """Node-level 'seed' attribute wins; otherwise the instance RNG
        draws, so reseed() makes whole-graph runs reproducible."""
        scale = _attr(node, "scale", 1.0)
        mean = _attr(node, "mean", 0.0)
        seed = _attr(node, "seed")
        rng = (np.random.default_rng(int(seed)) if seed is not None
               else self.rng)
        return (mean + scale * rng.standard_normal(x.shape)).astype(
            np.float32)

    def _exec_loop(self, node, env: Dict[str, Any]) -> None:
        """ONNX Loop: inputs [M, cond, v...]; body (iter, cond, v...) ->
        (cond, v..., scan...); outputs [v_final..., scan_stacked...]."""
        body = node.attributes["body"]
        m_name = node.inputs[0] if len(node.inputs) > 0 else ""
        cond_name = node.inputs[1] if len(node.inputs) > 1 else ""
        max_trip = (int(np.asarray(env[m_name]).reshape(()))
                    if m_name and env.get(m_name) is not None else None)
        cond = (bool(np.asarray(env[cond_name]).reshape(()))
                if cond_name and env.get(cond_name) is not None else True)
        carried = [env[name] for name in node.inputs[2:]]
        n_carried = len(carried)
        n_scan = len(body.outputs) - 1 - n_carried
        scans: List[List[np.ndarray]] = [[] for _ in range(n_scan)]
        if max_trip is None and not cond_name:
            raise ValueError(
                f"Loop node {node.name} has neither a trip count nor a "
                "condition — it would never terminate"
            )
        it = 0
        while cond and (max_trip is None or it < max_trip):
            child = self._subgraph_env(body, env)
            child[body.inputs[0]] = np.asarray(it, np.int64)
            child[body.inputs[1]] = np.asarray(cond)
            for name, val in zip(body.inputs[2:], carried):
                child[name] = val
            self._exec_nodes(body.nodes, child)
            cond = bool(np.asarray(child[body.outputs[0]]).reshape(()))
            carried = [child[n] for n in body.outputs[1:1 + n_carried]]
            for i, n in enumerate(body.outputs[1 + n_carried:]):
                scans[i].append(np.asarray(child[n]))
            it += 1
        outs = list(carried)
        if n_scan and not scans[0]:
            # zero trips: scan outputs are (0, *per-iteration-shape) with
            # the body's dtype — probe the (pure) body once to learn them,
            # so downstream Concat/Reshape/Gather see the right rank
            try:
                child = self._subgraph_env(body, env)
                child[body.inputs[0]] = np.asarray(0, np.int64)
                child[body.inputs[1]] = np.asarray(True)
                for name, val in zip(body.inputs[2:], carried):
                    child[name] = val
                self._exec_nodes(body.nodes, child)
                probes = [np.asarray(child[n])
                          for n in body.outputs[1 + n_carried:]]
                empties = [np.zeros((0,) + p.shape, p.dtype) for p in probes]
            except Exception:  # un-probeable body: degrade to (0,) f32
                empties = [np.zeros((0,), np.float32)] * n_scan
            outs.extend(empties)
        else:
            for s in scans:
                outs.append(np.stack(s))
        for out_name, value in zip(node.outputs, outs):
            if out_name:
                env[out_name] = value


# ---------------------------------------------------------------------------
# Op implementations
# ---------------------------------------------------------------------------


def _attr(node: OnnxNode, name: str, default=None):
    return node.attributes.get(name, default)


def _axes_arg(node, axes_input, attr_name="axes"):
    if axes_input is not None:
        return tuple(int(a) for a in np.asarray(axes_input).reshape(-1))
    axes = _attr(node, attr_name)
    if axes is None:
        return None
    if isinstance(axes, int):
        return (axes,)
    return tuple(int(a) for a in axes)


def _op_binary(fn):
    def handler(node, a, b):
        return fn(a, b)

    return handler


def _op_unary(fn):
    def handler(node, x):
        return fn(x)

    return handler


def _op_gemm(node, a, b, c=None):
    alpha = _attr(node, "alpha", 1.0)
    beta = _attr(node, "beta", 1.0)
    if _attr(node, "transA", 0):
        a = a.T
    if _attr(node, "transB", 0):
        b = b.T
    out = alpha * (a @ b)
    if c is not None:
        out = out + beta * c
    return out.astype(np.float32)


def _conv_pad_list(node, x_shape, kernel, strides, dilations, spatial):
    """Resolve a conv's pads attribute, honoring auto_pad (SAME_UPPER /
    SAME_LOWER / VALID) when explicit pads are absent. Total pad per
    axis is max((ceil(in/s)-1)*s + (k-1)*d + 1 - in, 0); SAME_UPPER
    puts the odd sample at the end, SAME_LOWER at the start."""
    pads = _attr(node, "pads")
    auto_pad = _attr(node, "auto_pad", "NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if pads is None:
        if auto_pad in ("SAME_UPPER", "SAME_LOWER"):
            begins, ends = [], []
            for i, (k, d, stride) in enumerate(
                    zip(kernel, dilations, strides)):
                in_size = x_shape[2 + i]
                out_size = -(-in_size // stride)
                total = max(
                    (out_size - 1) * stride + (k - 1) * d + 1 - in_size, 0
                )
                small, big = total // 2, total - total // 2
                if auto_pad == "SAME_UPPER":
                    begins.append(small)
                    ends.append(big)
                else:
                    begins.append(big)
                    ends.append(small)
            pads = begins + ends
        else:
            pads = [0] * (2 * spatial)
    return list(pads)


def _op_conv(node, x, w, b=None):
    """Conv 1D/2D/3D in float32 with torch.nn.functional on the CPU."""
    import torch
    import torch.nn.functional as F

    group = _attr(node, "group", 1)
    spatial = x.ndim - 2
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    kernel = w.shape[2:]
    pads = _conv_pad_list(node, x.shape, kernel, strides, dilations,
                          spatial)
    xt = torch.from_numpy(np.array(x, np.float32))
    wt = torch.from_numpy(np.array(w, np.float32))
    # F.pad lists the last axis first; conv pads may be asymmetric
    xt = F.pad(xt, [p for i in reversed(range(spatial))
                    for p in (pads[i], pads[i + spatial])])
    conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
    out = conv(xt, wt, stride=strides, dilation=dilations,
               groups=group).numpy()
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * spatial)
    return out.astype(np.float32)


def _op_reshape(node, data, shape):
    shape = [int(s) for s in np.asarray(shape).reshape(-1)]
    out_shape = []
    for i, s in enumerate(shape):
        out_shape.append(data.shape[i] if s == 0 else s)
    return np.reshape(data, out_shape)


def _op_slice(node, data, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset < 10: attributes
        starts = _attr(node, "starts")
        ends = _attr(node, "ends")
        axes = _attr(node, "axes")
        steps = None
    starts = [int(v) for v in np.asarray(starts).reshape(-1)]
    ends = [int(v) for v in np.asarray(ends).reshape(-1)]
    if axes is None:
        axes = list(range(len(starts)))
    else:
        axes = [int(v) for v in np.asarray(axes).reshape(-1)]
    if steps is None:
        steps = [1] * len(starts)
    else:
        steps = [int(v) for v in np.asarray(steps).reshape(-1)]
    slices = [slice(None)] * data.ndim
    for start, end, axis, step in zip(starts, ends, axes, steps):
        slices[axis] = slice(start, end, step)
    return data[tuple(slices)]


def _guard_rnn_attrs(node, n_default_acts: int) -> None:
    """Refuse RNN attributes the recurrences silently ignore: layout=1
    (batch-major io), non-default activations, clip. Silent-wrong output
    violates this module's coverage-gaps-raise contract."""
    if _attr(node, "layout", 0):
        raise NotImplementedError(
            f"{node.op_type} layout=1 (batch-major) not supported")
    acts = _attr(node, "activations")
    if acts is not None:
        defaults = {
            2: ["Sigmoid", "Tanh"], 3: ["Sigmoid", "Tanh", "Tanh"],
        }[n_default_acts]
        got = [a.decode() if isinstance(a, bytes) else str(a)
               for a in (acts if isinstance(acts, (list, tuple)) else [acts])]
        # bidirectional doubles the list with the same defaults
        if got not in (defaults, defaults * 2):
            raise NotImplementedError(
                f"{node.op_type} custom activations {got} not supported")
    if _attr(node, "clip") is not None:
        raise NotImplementedError(
            f"{node.op_type} cell-clip not supported")


def _op_lstm(node, x, w, r, b=None, seq_lens=None, h0=None, c0=None, p=None):
    """Single-direction LSTM, gates iofc (ONNX spec), layout [T, B, I].

    ``sequence_lens`` follows the ONNX masked semantics: past a row's
    length the state freezes (Y_h/Y_c hold the last valid step) and the
    per-step output Y is zero; the reverse direction processes each
    row's *valid prefix* reversed (padding never enters the recurrence).
    """
    _guard_rnn_attrs(node, 3)
    lens = _norm_seq_lens(seq_lens, x)
    if p is not None and np.asarray(p).size:
        raise NotImplementedError("LSTM peephole weights not supported")
    hidden = int(_attr(node, "hidden_size"))
    direction = _attr(node, "direction", "forward")
    t_len, batch, _ = x.shape

    def run_dir(d, reverse):
        wd, rd = w[d], r[d]
        bd = b[d] if b is not None else np.zeros(8 * hidden, np.float32)
        wb, rb = bd[:4 * hidden], bd[4 * hidden:]
        h = (h0[d] if h0 is not None else
             np.zeros((batch, hidden), np.float32))
        c = (c0[d] if c0 is not None else
             np.zeros((batch, hidden), np.float32))
        xs = _reverse_rows(x, lens) if reverse else x
        outs = []
        for t in range(t_len):
            gates = xs[t] @ wd.T + wb + h @ rd.T + rb
            i = _sigmoid(gates[:, :hidden])
            o = _sigmoid(gates[:, hidden:2 * hidden])
            f = _sigmoid(gates[:, 2 * hidden:3 * hidden])
            g = np.tanh(gates[:, 3 * hidden:])
            c_new = f * c + i * g
            h_new = o * np.tanh(c_new)
            if lens is None:
                h, c = h_new, c_new
                outs.append(h_new)
            else:
                mask = (t < lens)[:, None]
                h = np.where(mask, h_new, h)
                c = np.where(mask, c_new, c)
                outs.append(np.where(mask, h_new, np.float32(0.0)))
        y = np.stack(outs)
        if reverse:
            y = _reverse_rows(y, lens)
        return y, h, c

    results = []
    if direction in ("forward", "bidirectional"):
        results.append(run_dir(0, False))
    if direction in ("reverse", "bidirectional"):
        results.append(run_dir(0 if direction == "reverse" else 1, True))
    y = np.stack([res[0] for res in results], axis=1)  # [T, D, B, H]
    y_h = np.stack([res[1] for res in results])  # [D, B, H]
    y_c = np.stack([res[2] for res in results])
    return y.astype(np.float32), y_h.astype(np.float32), y_c.astype(np.float32)


def _op_gru(node, x, w, r, b=None, seq_lens=None, h0=None):
    """Single/bi-directional GRU, gates zrh (masked ``sequence_lens``
    semantics as in :func:`_op_lstm`)."""
    _guard_rnn_attrs(node, 2)
    lens = _norm_seq_lens(seq_lens, x)
    hidden = int(_attr(node, "hidden_size"))
    direction = _attr(node, "direction", "forward")
    linear_before_reset = _attr(node, "linear_before_reset", 0)
    t_len, batch, _ = x.shape

    def run_dir(d, reverse):
        wd, rd = w[d], r[d]
        bd = b[d] if b is not None else np.zeros(6 * hidden, np.float32)
        wb, rb = bd[:3 * hidden], bd[3 * hidden:]
        h = (h0[d] if h0 is not None else
             np.zeros((batch, hidden), np.float32))
        xs = _reverse_rows(x, lens) if reverse else x
        outs = []
        for t in range(t_len):
            gx = xs[t] @ wd.T + wb
            gh = h @ rd.T + rb
            z = _sigmoid(gx[:, :hidden] + gh[:, :hidden])
            rr = _sigmoid(gx[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
            if linear_before_reset:
                # ht = tanh(Wh x + Wbh + r (.) (Rh h + Rbh))
                n = np.tanh(gx[:, 2 * hidden:] + rr * gh[:, 2 * hidden:])
            else:
                # default: ht = tanh(Wh x + Wbh + (r (.) h) Rh^T + Rbh)
                n = np.tanh(
                    gx[:, 2 * hidden:]
                    + (rr * h) @ rd[2 * hidden:].T
                    + rb[2 * hidden:]
                )
            h_new = (1 - z) * n + z * h
            if lens is None:
                h = h_new
                outs.append(h_new)
            else:
                mask = (t < lens)[:, None]
                h = np.where(mask, h_new, h)
                outs.append(np.where(mask, h_new, np.float32(0.0)))
        y = np.stack(outs)
        if reverse:
            y = _reverse_rows(y, lens)
        return y, h

    results = []
    if direction in ("forward", "bidirectional"):
        results.append(run_dir(0, False))
    if direction in ("reverse", "bidirectional"):
        results.append(run_dir(0 if direction == "reverse" else 1, True))
    y = np.stack([res[0] for res in results], axis=1)
    y_h = np.stack([res[1] for res in results])
    return y.astype(np.float32), y_h.astype(np.float32)


def _reduce_variadic(np_fn, xs):
    if not xs:
        raise ValueError("variadic op needs at least one input")
    out = np.asarray(xs[0])
    for x in xs[1:]:
        out = np_fn(out, x)
    return out


def _softmax_legacy(node, x, log: bool):
    """opset < 13 Softmax/LogSoftmax: axis defaults to 1 and the input is
    COERCED to a 2-D [prod(:axis), prod(axis:)] batch — normalization
    runs over the whole flattened trailing block, not one axis."""
    axis = _attr(node, "axis", 1)
    if axis < 0:
        axis += x.ndim
    lead = int(np.prod(x.shape[:axis], dtype=np.int64)) if axis else 1
    flat = np.asarray(x).reshape(lead, -1)
    e = np.exp(flat - np.max(flat, axis=1, keepdims=True))
    s = e / e.sum(axis=1, keepdims=True)
    out = np.log(s) if log else s
    return out.reshape(x.shape).astype(np.float32)


def _op_softmax(node, x):
    axis = _attr(node, "axis", -1)
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _op_reduce(fn, default_keepdims=1):
    def handler(node, data, axes_in=None):
        axes = _axes_arg(node, axes_in)
        if axes == ():
            # an EMPTY axes tensor reduces over every axis unless
            # noop_with_empty_axes is set (numpy's axis=() is a no-op —
            # the exact opposite)
            axes = None if not _attr(node, "noop_with_empty_axes", 0)                 else ()
        keepdims = bool(_attr(node, "keepdims", default_keepdims))
        return fn(data, axis=axes, keepdims=keepdims)

    return handler


def _op_layer_norm(node, x, scale, bias=None):
    axis = _attr(node, "axis", -1)
    eps = _attr(node, "epsilon", 1e-5)
    axes = tuple(range(axis if axis >= 0 else x.ndim + axis, x.ndim))
    mean = x.mean(axis=axes, keepdims=True)
    var = x.var(axis=axes, keepdims=True)
    out = (x - mean) / np.sqrt(var + eps) * scale
    if bias is not None:
        out = out + bias
    return out.astype(np.float32)


def _op_pad(node, data, pads=None, value=None, axes=None):
    if pads is None:
        pads = _attr(node, "pads")
    pads = [int(v) for v in np.asarray(pads).reshape(-1)]
    mode = _attr(node, "mode", "constant")
    ndim = data.ndim
    if axes is not None:
        # opset-18 form: pads has 2*len(axes) entries paired per axis
        axis_list = [int(a) % ndim for a in np.asarray(axes).reshape(-1)]
        n = len(axis_list)
        pad_width = [(0, 0)] * ndim
        for j, axis in enumerate(axis_list):
            pad_width[axis] = (pads[j], pads[j + n])
    else:
        pad_width = [(pads[i], pads[i + ndim]) for i in range(ndim)]
    if any(lo < 0 or hi < 0 for lo, hi in pad_width):
        # negative pads CROP from that edge (ONNX spec); np.pad rejects
        # negative widths, so slice the crops off first
        crops = tuple(
            slice(max(-lo, 0), dim - max(-hi, 0))
            for (lo, hi), dim in zip(pad_width, data.shape))
        data = data[crops]
        pad_width = [(max(lo, 0), max(hi, 0)) for lo, hi in pad_width]
    if mode == "constant":
        constant = float(np.asarray(value).reshape(-1)[0]) if value is not None else 0.0
        return np.pad(data, pad_width, constant_values=constant)
    return np.pad(data, pad_width, mode={"reflect": "reflect",
                                         "edge": "edge"}[mode])


def _op_cast(node, x):
    return x.astype(_DTYPE_BY_ONNX[int(_attr(node, "to"))])


def _op_constant(node):
    for key in ("value", "value_float", "value_int"):
        if key in node.attributes:
            val = node.attributes[key]
            return np.asarray(val)
    raise NotImplementedError("Constant without value")


def _op_split(node, data, split=None):
    axis = _attr(node, "axis", 0)
    if split is None:
        split = _attr(node, "split")
    if split is None:
        num_outputs = _attr(node, "num_outputs", len(node.outputs))
        # opset-18: chunks are ceil(dim/num_outputs) with the LAST one
        # holding the remainder (floor-first puts it in the wrong chunk)
        dim = data.shape[axis]
        chunk = -(-dim // num_outputs)
        sizes = [chunk] * (num_outputs - 1)
        sizes.append(dim - chunk * (num_outputs - 1))
    else:
        sizes = [int(s) for s in np.asarray(split).reshape(-1)]
    indices = np.cumsum(sizes)[:-1]
    return tuple(np.split(data, indices, axis=axis))


def _op_expand(node, data, shape):
    shape = [int(s) for s in np.asarray(shape).reshape(-1)]
    return np.broadcast_to(data, np.broadcast_shapes(data.shape,
                                                     tuple(shape))).copy()


def _op_where(node, cond, a, b):
    return np.where(cond, a, b)


def _op_gather(node, data, indices):
    axis = _attr(node, "axis", 0)
    return np.take(data, np.asarray(indices, np.int64), axis=axis)


def _op_unsqueeze(node, data, axes_in=None):
    axes = _axes_arg(node, axes_in)
    out = data
    for axis in sorted(axes):
        out = np.expand_dims(out, axis)
    return out


def _op_squeeze(node, data, axes_in=None):
    axes = _axes_arg(node, axes_in)
    if axes is None:
        return np.squeeze(data)
    return np.squeeze(data, axis=tuple(axes))


def _arg_extremum(np_fn, node, data):
    axis = _attr(node, "axis", 0)
    keepdims = bool(_attr(node, "keepdims", 1))
    if _attr(node, "select_last_index", 0):
        # spec: ties resolve to the LAST occurrence; numpy returns the
        # first — flip the axis and mirror the index
        n = data.shape[axis]
        out = n - 1 - np_fn(np.flip(data, axis=axis), axis=axis)
    else:
        out = np_fn(data, axis=axis)
    if keepdims:
        out = np.expand_dims(out, axis)
    return out.astype(np.int64)


def _op_argmax(node, data):
    return _arg_extremum(np.argmax, node, data)


def _op_clip(node, x, lo=None, hi=None):
    lo = _attr(node, "min") if lo is None else lo
    hi = _attr(node, "max") if hi is None else hi
    if lo is None and hi is None:
        return x  # legal identity Clip; np.clip rejects two Nones
    return np.clip(x, lo, hi)


def _op_constant_of_shape(node, shape):
    value = _attr(node, "value")
    shape = [int(s) for s in np.asarray(shape).reshape(-1)]
    if value is None:
        return np.zeros(shape, np.float32)
    value = np.asarray(value)
    return np.full(shape, value.reshape(-1)[0], dtype=value.dtype)


def _op_range(node, start, limit, delta):
    return np.arange(
        np.asarray(start).item(), np.asarray(limit).item(),
        np.asarray(delta).item(),
    )


def _op_transpose(node, data):
    perm = _attr(node, "perm")
    return np.transpose(data, perm)


def _op_tile(node, data, repeats):
    return np.tile(data, [int(r) for r in np.asarray(repeats).reshape(-1)])


def _op_cumsum(node, x, axis):
    axis = int(np.asarray(axis).item())
    exclusive = int(_attr(node, "exclusive", 0))
    reverse = int(_attr(node, "reverse", 0))
    if reverse:
        x = np.flip(x, axis=axis)
    out = np.cumsum(x, axis=axis)
    if exclusive:
        out = np.roll(out, 1, axis=axis)
        idx = [slice(None)] * out.ndim
        idx[axis] = 0
        out[tuple(idx)] = 0
    if reverse:
        out = np.flip(out, axis=axis)
    return out


_OPS = {
    "Add": _op_binary(np.add),
    "Sub": _op_binary(np.subtract),
    "Mul": _op_binary(np.multiply),
    "Div": _op_binary(lambda a, b: np.divide(a, b)
                      if np.issubdtype(np.asarray(a).dtype, np.floating)
                      or np.issubdtype(np.asarray(b).dtype, np.floating)
                      else _int_div(a, b)),
    "Pow": _op_binary(np.power),
    "MatMul": _op_binary(lambda a, b: (a @ b).astype(np.result_type(a, b))),
    "And": _op_binary(np.logical_and),
    "Or": _op_binary(np.logical_or),
    "Equal": _op_binary(np.equal),
    "Greater": _op_binary(np.greater),
    "GreaterOrEqual": _op_binary(np.greater_equal),
    "Less": _op_binary(np.less),
    "LessOrEqual": _op_binary(np.less_equal),
    # variadic (1..N inputs) per spec, unlike the other binaries
    "Min": lambda node, *xs: _reduce_variadic(np.minimum, xs),
    "Max": lambda node, *xs: _reduce_variadic(np.maximum, xs),
    "Relu": _op_unary(lambda x: np.maximum(x, 0)),
    "Sigmoid": _op_unary(_sigmoid),
    "Tanh": _op_unary(np.tanh),
    "Erf": _op_unary(lambda x: _erf(x).astype(x.dtype)),
    "Exp": _op_unary(np.exp),
    "Log": _op_unary(np.log),
    "Sqrt": _op_unary(np.sqrt),
    "Neg": _op_unary(np.negative),
    "Abs": _op_unary(np.abs),
    "Sin": _op_unary(np.sin),
    "Cos": _op_unary(np.cos),
    "Mod": lambda node, a, b: (np.fmod(a, b) if _attr(node, "fmod", 0)
                               else np.mod(a, b)),
    "Einsum": lambda node, *args: np.einsum(
        _attr(node, "equation").decode("utf-8")
        if isinstance(_attr(node, "equation"), bytes)
        else _attr(node, "equation"), *args),
    "Floor": _op_unary(np.floor),
    "Ceil": _op_unary(np.ceil),
    "Not": _op_unary(np.logical_not),
    "Identity": _op_unary(lambda x: x),
    "Shape": _op_unary(lambda x: np.asarray(x.shape, np.int64)),
    "Size": _op_unary(lambda x: np.asarray(x.size, np.int64)),
    "Flatten": lambda node, x: x.reshape(
        int(np.prod(x.shape[:_attr(node, "axis", 1)]) or 1), -1
    ),
    "Dropout": lambda node, x, *rest: x,
    "Softmax": _op_softmax,
    "LogSoftmax": lambda node, x: np.log(_op_softmax(node, x)),
    "Gemm": _op_gemm,
    "Conv": _op_conv,
    "Reshape": _op_reshape,
    "Slice": _op_slice,
    "Concat": lambda node, *parts: np.concatenate(
        [p for p in parts if p is not None], axis=_attr(node, "axis", 0)
    ),
    "Gather": _op_gather,
    "Unsqueeze": _op_unsqueeze,
    "Squeeze": _op_squeeze,
    "Transpose": _op_transpose,
    "Cast": _op_cast,
    "Constant": lambda node: _op_constant(node),
    "ConstantOfShape": _op_constant_of_shape,
    "Expand": _op_expand,
    "Where": _op_where,
    "Range": _op_range,
    "Tile": _op_tile,
    "CumSum": _op_cumsum,
    "ArgMax": _op_argmax,
    "Clip": _op_clip,
    "Split": _op_split,
    "Pad": _op_pad,
    "ReduceMean": _op_reduce(np.mean),
    "ReduceSum": _op_reduce(np.sum),
    "ReduceMax": _op_reduce(np.max),
    "ReduceMin": _op_reduce(np.min),
    "ReduceProd": _op_reduce(np.prod),
    "LayerNormalization": _op_layer_norm,
    "LSTM": _op_lstm,
    "GRU": _op_gru,
}


def _op_gather_elements(node, data, indices):
    axis = _attr(node, "axis", 0)
    return np.take_along_axis(data, np.asarray(indices, np.int64), axis=axis)


def _op_conv_transpose(node, x, w, b=None):
    """1D/2D/3D transposed conv (torch layout [I, O/g, K...]) in float32
    with torch.nn.functional on the CPU: the full transposed conv, then
    ``pads`` cropped from each end of each axis (ONNX semantics, with
    ``dilations`` and ``output_padding``)."""
    import torch
    import torch.nn.functional as F

    spatial = x.ndim - 2
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    out_pad = tuple(_attr(node, "output_padding", [0] * spatial))
    pads = list(_attr(node, "pads", [0] * (2 * spatial)))
    group = _attr(node, "group", 1)
    if _attr(node, "output_shape") is not None or _attr(
            node, "auto_pad", "NOTSET") not in ("NOTSET", b"NOTSET"):
        raise NotImplementedError(
            "ConvTranspose output_shape / auto_pad not supported")
    conv = (F.conv_transpose1d, F.conv_transpose2d,
            F.conv_transpose3d)[spatial - 1]
    out = conv(torch.from_numpy(np.array(x, np.float32)),
               torch.from_numpy(np.array(w, np.float32)),
               stride=strides, output_padding=out_pad, groups=group,
               dilation=dilations)
    crop = (slice(None), slice(None)) + tuple(
        slice(pads[i], out.shape[2 + i] - pads[i + spatial])
        for i in range(spatial))
    out = out[crop].numpy()
    if b is not None:
        out = out + b.reshape((1, -1) + (1,) * spatial)
    return out.astype(np.float32)


_OPS.update({
    "GatherElements": _op_gather_elements,
    "Softplus": _op_unary(
        lambda x: np.logaddexp(0.0, x).astype(np.float32)
    ),
    "LeakyRelu": lambda node, x: np.where(
        x >= 0, x, x * _attr(node, "alpha", 0.01)
    ).astype(np.float32),
    "ConvTranspose": _op_conv_transpose,
    # NOTE: no "RandomNormalLike" entry — the executor intercepts it in
    # _exec_nodes so draws come from the reseedable instance RNG; a
    # table entry would be dead code with DIFFERENT seeding semantics
})


# ---------------------------------------------------------------------------
# Quantized ops (int8 exports: onnxruntime dynamic/static quantization)
# ---------------------------------------------------------------------------
#
# Integer accumulations are computed exactly in int64 (the f32 conv path
# above is NOT exact once partial sums pass 2^24), rounding is
# round-half-to-even per the ONNX spec (np.rint).


def _per_axis(arr, ndim: int, axis: int):
    """Scale/zero-point broadcast: scalar stays scalar; 1-D maps to axis."""
    a = np.asarray(arr)
    if a.ndim == 0 or a.size == 1:
        return a.reshape(())
    shape = [1] * ndim
    shape[axis] = a.size
    return a.reshape(shape)


def _saturate(values, dtype):
    info = np.iinfo(dtype)
    return np.clip(values, info.min, info.max).astype(dtype)


def _op_quantize_linear(node, x, scale, zp=None):
    axis = _attr(node, "axis", 1)
    s = _per_axis(scale, x.ndim, axis)
    dtype = zp.dtype if zp is not None else np.uint8
    z = _per_axis(zp, x.ndim, axis).astype(np.int32) if zp is not None else 0
    return _saturate(np.rint(x / s).astype(np.int32) + z, dtype)


def _op_dequantize_linear(node, x, scale, zp=None):
    axis = _attr(node, "axis", 1)
    s = _per_axis(scale, x.ndim, axis).astype(np.float32)
    z = _per_axis(zp, x.ndim, axis).astype(np.int32) if zp is not None else 0
    return ((x.astype(np.int32) - z) * s).astype(np.float32)


def _op_dynamic_quantize_linear(node, x):
    # All scale math in f32, per the ONNX spec (and so the XLA lowering
    # in onnx/jax_lowering.py — same IEEE f32 single-rounding ops — is
    # bit-equal to this interpreter).
    x = np.asarray(x, np.float32)
    rmin = np.minimum(x.min() if x.size else np.float32(0), np.float32(0))
    rmax = np.maximum(x.max() if x.size else np.float32(0), np.float32(0))
    scale = np.float32(rmax - rmin) / np.float32(255)
    if scale == 0.0:
        scale = np.float32(1)
    zp = np.uint8(np.clip(np.rint(np.float32(0) - rmin / scale), 0, 255))
    y = _saturate(np.rint(x / scale).astype(np.int32) + np.int32(zp),
                  np.uint8)
    return y, np.float32(scale), zp


def _int_matmul(a, b, a_zp=None, b_zp=None):
    """Exact (A - a_zp) @ (B - b_zp) in int64, returned as int32."""
    a64 = np.asarray(a).astype(np.int64)
    b64 = np.asarray(b).astype(np.int64)
    if a_zp is not None:
        z = np.asarray(a_zp, np.int64)
        a64 = a64 - (z.reshape(-1, 1) if z.ndim == 1 and z.size > 1 else z)
    if b_zp is not None:
        z = np.asarray(b_zp, np.int64)
        b64 = b64 - (z.reshape(1, -1) if z.ndim == 1 and z.size > 1 else z)
    return (a64 @ b64).astype(np.int32)


def _op_matmul_integer(node, a, b, a_zp=None, b_zp=None):
    return _int_matmul(a, b, a_zp, b_zp)


def _op_qlinear_matmul(node, a, a_scale, a_zp, b, b_scale, b_zp,
                       y_scale, y_zp):
    # f32 single-rounding requant (like ort's MlasRequantize and the XLA
    # lowering in onnx/jax_lowering.py — same IEEE ops, bit-equal)
    acc = _int_matmul(a, b, a_zp, b_zp).astype(np.float32)
    scale = (np.asarray(a_scale, np.float32)
             * np.asarray(b_scale, np.float32)
             / np.asarray(y_scale, np.float32))
    y = np.rint(acc * scale).astype(np.int64) + np.asarray(y_zp, np.int64)
    return _saturate(y, np.asarray(y_zp).dtype)


def _int_conv_exact(node, x, w, x_zp=None, w_zp=None):
    """Exact integer conv via im2col + int64 matmul (1D/2D, groups)."""
    spatial = x.ndim - 2
    group = _attr(node, "group", 1)
    strides = tuple(_attr(node, "strides", [1] * spatial))
    dilations = tuple(_attr(node, "dilations", [1] * spatial))
    pads = _conv_pad_list(node, x.shape, w.shape[2:], strides, dilations,
                          spatial)
    x64 = np.asarray(x).astype(np.int64)
    w64 = np.asarray(w).astype(np.int64)
    if x_zp is not None:
        x64 = x64 - np.asarray(x_zp, np.int64)  # scalar per spec
    if w_zp is not None:
        z = np.asarray(w_zp, np.int64)
        if z.ndim == 1 and z.size > 1:  # per output channel
            w64 = w64 - z.reshape((-1,) + (1,) * (w64.ndim - 1))
        else:
            w64 = w64 - z
    if spatial == 1:
        x64 = x64[..., None]
        w64 = w64[..., None]
        strides = strides + (1,)
        dilations = dilations + (1,)
        pads = [pads[0], 0, pads[1], 0]
    n, c_in, h, wd = x64.shape
    c_out, c_in_g, kh, kw = w64.shape
    xp = np.pad(x64, ((0, 0), (0, 0), (pads[0], pads[2]),
                      (pads[1], pads[3])))
    oh = (xp.shape[2] - (kh - 1) * dilations[0] - 1) // strides[0] + 1
    ow = (xp.shape[3] - (kw - 1) * dilations[1] - 1) // strides[1] + 1
    cols = np.empty((n, c_in, kh, kw, oh, ow), np.int64)
    for i in range(kh):
        for j in range(kw):
            hi = i * dilations[0]
            wj = j * dilations[1]
            cols[:, :, i, j] = xp[
                :, :,
                hi:hi + oh * strides[0]:strides[0],
                wj:wj + ow * strides[1]:strides[1],
            ]
    out = np.empty((n, c_out, oh, ow), np.int64)
    og = c_out // group
    for g in range(group):
        col_g = cols[:, g * c_in_g:(g + 1) * c_in_g]
        col2 = col_g.reshape(n, c_in_g * kh * kw, oh * ow)
        w2 = w64[g * og:(g + 1) * og].reshape(og, c_in_g * kh * kw)
        out[:, g * og:(g + 1) * og] = (
            np.einsum("ok,nkp->nop", w2, col2).reshape(n, og, oh, ow)
        )
    if spatial == 1:
        out = out[..., 0]
    return out


def _op_conv_integer(node, x, w, x_zp=None, w_zp=None):
    return _int_conv_exact(node, x, w, x_zp, w_zp).astype(np.int32)


def _op_qlinear_conv(node, x, x_scale, x_zp, w, w_scale, w_zp,
                     y_scale, y_zp, b=None):
    acc = _int_conv_exact(node, x, w, x_zp, w_zp)
    if b is not None:  # int32 bias at scale x_scale*w_scale
        acc = acc + np.asarray(b, np.int64).reshape(
            (1, -1) + (1,) * (acc.ndim - 2))
    # f32 single-rounding requant (see _op_qlinear_matmul)
    scale = (np.asarray(x_scale, np.float32)
             * np.asarray(w_scale, np.float32)
             / np.asarray(y_scale, np.float32))
    s = _per_axis(scale, acc.ndim, 1)
    y = (np.rint(acc.astype(np.float32) * s).astype(np.int64)
         + np.asarray(y_zp, np.int64))
    return _saturate(y, np.asarray(y_zp).dtype)


_OPS.update({
    "QuantizeLinear": _op_quantize_linear,
    "DequantizeLinear": _op_dequantize_linear,
    "DynamicQuantizeLinear": _op_dynamic_quantize_linear,
    "MatMulInteger": _op_matmul_integer,
    "QLinearMatMul": _op_qlinear_matmul,
    "ConvInteger": _op_conv_integer,
    "QLinearConv": _op_qlinear_conv,
})


# ---------------------------------------------------------------------------
# Long-tail ops for foreign graphs (scripted torch exports, coqui-style
# voices): scatter/gather families, TopK, OneHot, sequence reversal.
# Control flow (If/Loop) lives on the executor itself — subgraphs need
# scoped execution, see OnnxExecutor._exec_if/_exec_loop.
# ---------------------------------------------------------------------------


_SCATTER_REDUCERS = {
    "add": np.add.at,
    "mul": np.multiply.at,
    "max": np.maximum.at,
    "min": np.minimum.at,
}


def _scatter(out, ix, updates, reduction):
    reducer = _SCATTER_REDUCERS.get(reduction)
    if reducer is not None:
        reducer(out, ix, np.asarray(updates))
    else:  # "none": plain assignment
        out[ix] = np.asarray(updates)
    return out


def _op_scatter_nd(node, data, indices, updates):
    idx = np.asarray(indices).astype(np.int64)
    ix = tuple(np.moveaxis(idx, -1, 0))
    return _scatter(np.array(data, copy=True), ix, updates,
                    _attr(node, "reduction", "none"))


def _op_scatter_elements(node, data, indices, updates):
    axis = _attr(node, "axis", 0)
    out = np.array(data, copy=True)
    idx = np.asarray(indices).astype(np.int64)
    idx = np.where(idx < 0, idx + out.shape[axis], idx)
    grid = list(np.indices(idx.shape))
    grid[axis] = idx
    return _scatter(out, tuple(grid), updates,
                    _attr(node, "reduction", "none"))


def _op_gather_nd(node, data, indices):
    batch_dims = _attr(node, "batch_dims", 0)
    data = np.asarray(data)
    idx = np.asarray(indices).astype(np.int64)
    if not batch_dims:
        return data[tuple(np.moveaxis(idx, -1, 0))]
    # fold the leading batch dims into an extra index column (spec: the
    # first batch_dims dims of data and indices match and are gathered
    # elementwise)
    bshape = data.shape[:batch_dims]
    d2 = data.reshape((-1,) + data.shape[batch_dims:])
    i2 = idx.reshape((-1,) + idx.shape[batch_dims:])
    rows = np.arange(d2.shape[0]).reshape(
        (-1,) + (1,) * (i2.ndim - 1))
    rows = np.broadcast_to(rows, i2.shape[:-1] + (1,))
    i3 = np.concatenate([rows, i2], axis=-1)
    out = d2[tuple(np.moveaxis(i3, -1, 0))]
    return out.reshape(bshape + out.shape[1:])


def _op_topk(node, x, k):
    axis = _attr(node, "axis", -1)
    largest = _attr(node, "largest", 1)
    x = np.asarray(x)
    k = int(np.asarray(k).reshape(()))
    order = np.argsort(-x if largest else x, axis=axis, kind="stable")
    idx = np.take(order, np.arange(k), axis=axis)
    values = np.take_along_axis(x, idx, axis=axis)
    return values, idx.astype(np.int64)


def _op_one_hot(node, indices, depth, values):
    axis = _attr(node, "axis", -1)
    depth = int(np.asarray(depth).reshape(()))
    off_on = np.asarray(values).reshape(-1)
    idx = np.asarray(indices).astype(np.int64)
    idx = np.where(idx < 0, idx + depth, idx)
    hot = idx[..., None] == np.arange(depth)
    out = np.where(hot, off_on[1], off_on[0]).astype(off_on.dtype)
    dest = axis if axis >= 0 else out.ndim + axis
    return np.moveaxis(out, -1, dest)


def _op_reverse_sequence(node, x, sequence_lens):
    batch_axis = _attr(node, "batch_axis", 1)
    time_axis = _attr(node, "time_axis", 0)
    x = np.asarray(x)
    out = np.array(x, copy=True)
    lens = np.asarray(sequence_lens).astype(np.int64).reshape(-1)
    for b, n in enumerate(lens):
        if int(n) <= 0:
            continue  # slice(-1, None, -1) would select the WHOLE axis
        sel = [slice(None)] * x.ndim
        sel[batch_axis] = b
        rev = list(sel)
        sel[time_axis] = slice(0, int(n))
        rev[time_axis] = slice(int(n) - 1, None, -1)
        out[tuple(sel)] = x[tuple(rev)]
    return out


def _op_trilu(node, x, k=None):
    upper = _attr(node, "upper", 1)
    kk = int(np.asarray(k).reshape(())) if k is not None else 0
    return np.triu(x, kk) if upper else np.tril(x, kk)


def _op_argmin(node, data):
    return _arg_extremum(np.argmin, node, data)


_OPS.update({
    "ScatterND": _op_scatter_nd,
    "ScatterElements": _op_scatter_elements,
    "GatherND": _op_gather_nd,
    "NonZero": lambda node, x: np.stack(np.nonzero(x)).astype(np.int64),
    "Round": lambda node, x: np.rint(x),  # half-to-even, like ONNX
    "TopK": _op_topk,
    "OneHot": _op_one_hot,
    "ReverseSequence": _op_reverse_sequence,
    "Trilu": _op_trilu,
    "ArgMin": _op_argmin,
    "Sign": lambda node, x: np.sign(x),
    "Reciprocal": lambda node, x: np.reciprocal(np.asarray(x, np.float32))
    if np.asarray(x).dtype == np.float32 else 1.0 / np.asarray(x),
    "Sum": lambda node, *xs: functools.reduce(np.add, xs),
    "Mean": lambda node, *xs: functools.reduce(np.add, xs) / len(xs),
    "HardSigmoid": lambda node, x: np.clip(
        _attr(node, "alpha", 0.2) * x + _attr(node, "beta", 0.5), 0, 1),
    "Elu": lambda node, x: np.where(
        x > 0, x, _attr(node, "alpha", 1.0) * (np.exp(x) - 1)),
    "Selu": lambda node, x: _attr(node, "gamma", 1.0507009873554805) *
    np.where(x > 0, x, _attr(node, "alpha", 1.6732632423543772) *
             (np.exp(x) - 1)),
    "IsNaN": lambda node, x: np.isnan(x),
    "IsInf": lambda node, x: np.isinf(x),
    "Xor": lambda node, a, b: np.logical_xor(a, b),
})
