"""Programmatic ONNX graph construction.

A thin builder over the writer's node/initializer model: auto-named value
edges, constant pooling, and helpers for the op patterns the VITS export
uses. Graphs produced here execute under onnxruntime (opset 15 ops only)
and under :mod:`phoonnx_tpu_torch.onnx.executor` for in-repo verification.
"""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

NodeSpec = Tuple[str, Sequence[str], Sequence[str], dict]


class GraphBuilder:
    def __init__(self, prefix: str = "v"):
        self.nodes: List[NodeSpec] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self._counter = 0
        self._prefix = prefix
        self._const_cache: Dict[Tuple, str] = {}

    # -- naming ----------------------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        return f"{self._prefix}{self._counter}_{hint}"

    # -- initializers ----------------------------------------------------

    def init(self, name: str, array: np.ndarray) -> str:
        self.initializers[name] = np.asarray(array)
        return name

    def const(self, array, dtype=None, hint: str = "c") -> str:
        array = np.asarray(array, dtype=dtype)
        key = (array.dtype.str, array.shape, array.tobytes())
        if key not in self._const_cache:
            name = self.fresh(hint)
            self.initializers[name] = array
            self._const_cache[key] = name
        return self._const_cache[key]

    def i64(self, values) -> str:
        return self.const(np.asarray(values, np.int64), hint="i64")

    def f32(self, values) -> str:
        return self.const(np.asarray(values, np.float32), hint="f32")

    # -- nodes -----------------------------------------------------------

    def n(self, op: str, inputs: Sequence[str], n_out: int = 1,
          hint: Optional[str] = None, **attrs) -> Union[str, List[str]]:
        outputs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append((op, list(inputs), outputs, attrs))
        return outputs[0] if n_out == 1 else outputs

    # -- common op sugar -------------------------------------------------

    def add(self, a, b):
        return self.n("Add", [a, b])

    def sub(self, a, b):
        return self.n("Sub", [a, b])

    def mul(self, a, b):
        return self.n("Mul", [a, b])

    def div(self, a, b):
        return self.n("Div", [a, b])

    def matmul(self, a, b):
        return self.n("MatMul", [a, b])

    def transpose(self, x, perm):
        return self.n("Transpose", [x], perm=list(perm))

    def reshape(self, x, shape):
        if isinstance(shape, (list, tuple)):
            shape = self.i64(shape)
        return self.n("Reshape", [x, shape])

    def concat(self, parts, axis):
        return self.n("Concat", parts, axis=axis)

    def slice_(self, x, starts, ends, axes, steps=None):
        inputs = [x, self.i64(starts), self.i64(ends), self.i64(axes)]
        if steps is not None:
            inputs.append(self.i64(steps))
        return self.n("Slice", inputs)

    def dyn_slice(self, x, starts_name, ends_name, axes):
        return self.n("Slice", [x, starts_name, ends_name, self.i64(axes)])

    def shape_of(self, x):
        return self.n("Shape", [x])

    def dim(self, x, index: int) -> str:
        """Scalar int64 tensor holding x.shape[index] (as 1-element vec)."""
        shape = self.shape_of(x)
        return self.n("Gather", [shape, self.i64([index])], axis=0)

    def cast(self, x, to: int):
        return self.n("Cast", [x], to=to)

    def unsqueeze(self, x, axes):
        return self.n("Unsqueeze", [x, self.i64(axes)])

    def squeeze(self, x, axes):
        return self.n("Squeeze", [x, self.i64(axes)])

    def conv1d(self, x, weight_name, bias_name=None, stride=1, padding=0,
               dilation=1, group=1):
        """x [B, C, T] with torch-layout weights [O, I/g, K]."""
        inputs = [x, weight_name]
        if bias_name is not None:
            inputs.append(bias_name)
        return self.n(
            "Conv", inputs, strides=[stride], pads=[padding, padding],
            dilations=[dilation], group=group,
        )

    def conv_transpose1d(self, x, weight_name, bias_name=None, stride=1,
                         padding=0):
        inputs = [x, weight_name]
        if bias_name is not None:
            inputs.append(bias_name)
        return self.n(
            "ConvTranspose", inputs, strides=[stride],
            pads=[padding, padding],
        )

    def sigmoid(self, x):
        return self.n("Sigmoid", [x])

    def tanh(self, x):
        return self.n("Tanh", [x])

    def relu(self, x):
        return self.n("Relu", [x])

    def leaky_relu(self, x, alpha):
        return self.n("LeakyRelu", [x], alpha=float(alpha))

    def softmax(self, x, axis=-1):
        return self.n("Softmax", [x], axis=axis)

    def softplus(self, x):
        return self.n("Softplus", [x])

    def exp(self, x):
        return self.n("Exp", [x])

    def log(self, x):
        return self.n("Log", [x])

    def sqrt(self, x):
        return self.n("Sqrt", [x])

    def neg(self, x):
        return self.n("Neg", [x])

    def where(self, cond, a, b):
        return self.n("Where", [cond, a, b])

    def equal(self, a, b):
        return self.n("Equal", [a, b])

    def less(self, a, b):
        return self.n("Less", [a, b])

    def greater_or_equal(self, a, b):
        return self.n("GreaterOrEqual", [a, b])

    def pad(self, x, pads, value: float = 0.0):
        """pads: flat [x1_begin.. xn_begin, x1_end.. xn_end] or tensor name."""
        if isinstance(pads, (list, tuple)):
            pads = self.i64(pads)
        return self.n("Pad", [x, pads, self.f32(value)])

    def reduce_sum(self, x, axes, keepdims=0):
        return self.n("ReduceSum", [x, self.i64(axes)], keepdims=keepdims)

    def reduce_max(self, x, axes=None, keepdims=0):
        if axes is None:
            return self.n("ReduceMax", [x], keepdims=keepdims)
        return self.n("ReduceMax", [x], axes=list(axes), keepdims=keepdims)

    def cumsum(self, x, axis: int):
        return self.n("CumSum", [x, self.i64(axis)])

    def range_(self, start, limit, delta):
        return self.n("Range", [start, limit, delta])

    def gather_elements(self, data, indices, axis):
        return self.n("GatherElements", [data, indices], axis=axis)

    def expand(self, x, shape_name):
        return self.n("Expand", [x, shape_name])

    def random_like(self, x, scale: float = 1.0):
        noise = self.n("RandomNormalLike", [x])
        if scale != 1.0:
            noise = self.mul(noise, self.f32(scale))
        return noise
