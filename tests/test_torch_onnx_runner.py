"""``TorchGraphRunner`` op by op, held against the JAX package's interpreter.

One parametrised test, one small graph a case: each is written with the
port's ONNX writer, read by both packages' readers and run by
``phoonnx_tpu.onnx.executor.OnnxExecutor`` and by the port's
``TorchGraphRunner`` on the CPU, on the same numpy inputs from a seed.
Floats agree within ``rtol=1e-5, atol=1e-6``; integers and booleans, the
quantized ops included, are equal, dtype and all. The case list covers
the runner's whole table (the interpreter's ``_OPS``) and the ops both
dispatch themselves (``If``, ``Loop``, ``RandomNormalLike`` and the pre-13
``Softmax``/``LogSoftmax``): a new op without a case fails
:func:`test_cases_cover_the_op_table`.
"""

import numpy as np
import pytest

from phoonnx_tpu.onnx.executor import OnnxExecutor
from phoonnx_tpu.onnx.reader import read_onnx as jax_read_onnx

from phoonnx_tpu_torch.onnx import torch_lowering
from phoonnx_tpu_torch.onnx.reader import read_onnx
from phoonnx_tpu_torch.onnx.torch_lowering import TorchGraphRunner
from phoonnx_tpu_torch.onnx.writer import write_onnx

from tests.test_torch_train_forward import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BIG = np.iinfo(np.int64).max


def f32(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def ints(*shape, lo=-5, hi=6, seed=0, dtype=np.int64):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def i64(*values):
    return np.asarray(values, np.int64)


def one(op, inputs, n_out=1, inits=None, opset=15, **attrs):
    """A one-node graph over ``inputs`` (name -> array; names starting
    with ``c_`` become initializers)."""
    names = list(inputs)
    outs = [f"y{i}" for i in range(n_out)]
    feeds = {k: v for k, v in inputs.items() if not k.startswith("c_")}
    init = dict(inits or {})
    init.update({k: v for k, v in inputs.items() if k.startswith("c_")})
    return dict(nodes=[(op, names, outs, attrs)], feeds=feeds, inits=init,
                outputs=outs, opset=opset)


def graph(nodes, feeds, outputs, inits=None, opset=15):
    return dict(nodes=nodes, feeds=feeds, inits=inits or {},
                outputs=outputs, opset=opset)


X = f32(2, 3, 4)
Y = f32(2, 3, 4, seed=1)
POS = np.abs(X) + 0.25
BOOL_A = ints(2, 5, lo=0, hi=2, seed=3).astype(bool)
BOOL_B = ints(2, 5, lo=0, hi=2, seed=4).astype(bool)
LSTM_H = 5


def _rnn(n_gates, n_dir, inp=3, seed=10):
    rng = np.random.default_rng(seed)
    h = LSTM_H
    w = (0.4 * rng.standard_normal((n_dir, n_gates * h, inp))).astype(
        np.float32)
    r = (0.4 * rng.standard_normal((n_dir, n_gates * h, h))).astype(
        np.float32)
    b = (0.1 * rng.standard_normal((n_dir, 2 * n_gates * h))).astype(
        np.float32)
    return w, r, b


def _lstm_case():
    w, r, b = _rnn(4, 2)
    return one("LSTM", {"x": f32(6, 3, 3, seed=5), "c_w": w, "c_r": r,
                        "c_b": b, "lens": np.asarray([6, 2, 4], np.int32),
                        "h0": f32(2, 3, LSTM_H, seed=6),
                        "c0": f32(2, 3, LSTM_H, seed=7)},
               n_out=3, hidden_size=LSTM_H, direction="bidirectional")


def _gru_case(direction, lbr):
    n_dir = 2 if direction == "bidirectional" else 1
    w, r, b = _rnn(3, n_dir, seed=11)
    return one("GRU", {"x": f32(5, 3, 3, seed=8), "c_w": w, "c_r": r,
                       "c_b": b, "lens": np.asarray([5, 1, 3], np.int32)},
               n_out=2, hidden_size=LSTM_H, direction=direction,
               linear_before_reset=lbr)


def _if_case(cond):
    then_g = {"name": "then", "nodes": [("Mul", ["x", "two"], ["t"])],
              "outputs": ["t"], "initializers": {"two": np.float32(2.0)}}
    else_g = {"name": "else", "nodes": [("Sub", ["x", "outer"], ["e"])],
              "outputs": ["e"]}
    return graph([("If", ["cond"], ["y"],
                   {"then_branch": then_g, "else_branch": else_g})],
                 {"cond": np.asarray(cond), "x": X, "outer": Y}, ["y"])


def _loop_body(extra_nodes=(), scan=True):
    nodes = [("Cast", ["iter"], ["iter_f"], {"to": 1}),
             ("Add", ["v_in", "iter_f"], ["v_a"]),
             ("Add", ["v_a", "outer"], ["v_out"]),
             ("Identity", ["cond_in"], ["cond_out"])]
    outputs = ["cond_out", "v_out"]
    if scan:
        nodes.append(("Mul", ["v_out", "v_out"], ["scan_out"]))
        outputs.append("scan_out")
    return {"name": "body", "nodes": nodes + list(extra_nodes),
            "inputs": ["iter", "cond_in", "v_in"], "outputs": outputs}


def _loop_case(trips):
    return graph([("Loop", ["M", "cond", "v0"], ["v_final", "squares"],
                   {"body": _loop_body()})],
                 {"M": np.asarray(trips, np.int64), "cond": np.asarray(True),
                  "v0": f32(3, seed=2), "outer": f32(3, seed=9)},
                 ["v_final", "squares"])


def _loop_cond_case():
    body = {"name": "body",
            "nodes": [("Add", ["v_in", "one"], ["v_out"]),
                      ("ReduceSum", ["v_out"], ["total"], {"keepdims": 0}),
                      ("Less", ["total", "limit"], ["cond_out"])],
            "inputs": ["iter", "cond_in", "v_in"],
            "outputs": ["cond_out", "v_out"],
            "initializers": {"one": np.float32(1.0)}}
    return graph([("Loop", ["", "cond", "v0"], ["v_final"], {"body": body})],
                 {"cond": np.asarray(True), "v0": f32(2, seed=3),
                  "limit": np.float32(9.0)}, ["v_final"])


def _quant_conv_inputs(seed=20):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (1, 4, 7, 6)).astype(np.uint8)
    w = rng.integers(-128, 128, (6, 2, 3, 2)).astype(np.int8)
    return x, w


CASES = {
    "Add": one("Add", {"a": X, "b": f32(4, seed=2)}),
    "Sub": one("Sub", {"a": X, "b": Y}),
    "Mul": one("Mul", {"a": X, "c_b": np.float32(0.5)}),
    "Div": one("Div", {"a": X, "b": POS}),
    "Div/int": one("Div", {"a": ints(3, 4), "b": ints(3, 4, lo=1, seed=1)
                           * np.where(ints(3, 4, lo=0, hi=2, seed=2), 1, -1)}),
    "Pow": one("Pow", {"a": POS, "b": Y}),
    "MatMul": one("MatMul", {"a": X, "b": f32(4, 5, seed=3)}),
    "MatMul/int": one("MatMul", {"a": ints(3, 4), "b": ints(4, 2, seed=1)}),
    "And": one("And", {"a": BOOL_A, "b": BOOL_B}),
    "Or": one("Or", {"a": BOOL_A, "b": BOOL_B}),
    "Xor": one("Xor", {"a": BOOL_A, "b": BOOL_B}),
    "Not": one("Not", {"a": BOOL_A}),
    "Equal": one("Equal", {"a": ints(4, 5), "b": ints(4, 5, seed=1)}),
    "Greater": one("Greater", {"a": X, "b": Y}),
    "GreaterOrEqual": one("GreaterOrEqual", {"a": ints(9), "b": ints(9, seed=1)}),
    "Less": one("Less", {"a": X, "b": Y}),
    "LessOrEqual": one("LessOrEqual", {"a": ints(9), "b": ints(9, seed=2)}),
    "Min": one("Min", {"a": X, "b": Y, "c": f32(4, seed=5)}),
    "Max": one("Max", {"a": X, "b": Y, "c": f32(4, seed=5)}),
    "Sum": one("Sum", {"a": X, "b": Y, "c": f32(3, 4, seed=5)}),
    "Mean": one("Mean", {"a": X, "b": Y}),
    "Relu": one("Relu", {"x": X}),
    "Sigmoid": one("Sigmoid", {"x": X}),
    "Tanh": one("Tanh", {"x": X}),
    "Erf": one("Erf", {"x": X}),
    "Exp": one("Exp", {"x": X}),
    "Log": one("Log", {"x": POS}),
    "Sqrt": one("Sqrt", {"x": POS}),
    "Neg": one("Neg", {"x": ints(3, 5)}),
    "Abs": one("Abs", {"x": X}),
    "Sin": one("Sin", {"x": X}),
    "Cos": one("Cos", {"x": X}),
    "Mod": one("Mod", {"a": ints(4, 5), "b": ints(4, 5, lo=1, seed=3)
                       * np.where(ints(4, 5, lo=0, hi=2, seed=4), 1, -1)}),
    "Mod/fmod": one("Mod", {"a": X, "b": POS}, fmod=1),
    "Einsum": one("Einsum", {"a": X, "b": f32(4, 2, seed=7)},
                  equation="bij,jk->bik"),
    "Floor": one("Floor", {"x": X * 3}),
    "Ceil": one("Ceil", {"x": X * 3}),
    "Round": one("Round", {"x": np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, 0.4,
                                            -2.6], np.float32)}),
    "Sign": one("Sign", {"x": np.concatenate([X.ravel(), [0.0]]).astype(
        np.float32)}),
    "Reciprocal": one("Reciprocal", {"x": POS}),
    "HardSigmoid": one("HardSigmoid", {"x": 3 * X}, alpha=0.3, beta=0.4),
    "Elu": one("Elu", {"x": X}, alpha=0.7),
    "Selu": one("Selu", {"x": X}),
    "LeakyRelu": one("LeakyRelu", {"x": X}, alpha=0.2),
    "Softplus": one("Softplus", {"x": 4 * X}),
    "Softmax": one("Softmax", {"x": X}, axis=1),
    "LogSoftmax": one("LogSoftmax", {"x": X}),
    "Softmax/legacy": one("Softmax", {"x": X}, opset=11, axis=1),
    "LogSoftmax/legacy": one("LogSoftmax", {"x": X}, opset=11),
    "IsNaN": one("IsNaN", {"x": np.asarray([1.0, np.nan, np.inf],
                                           np.float32)}),
    "IsInf": one("IsInf", {"x": np.asarray([1.0, np.nan, -np.inf],
                                           np.float32)}),
    "Identity": one("Identity", {"x": X}),
    "Dropout": one("Dropout", {"x": X}),
    "Shape": one("Shape", {"x": X}),
    "Size": one("Size", {"x": X}),
    "Flatten": one("Flatten", {"x": X}, axis=2),
    "Gemm": one("Gemm", {"a": f32(4, 3), "b": f32(5, 4, seed=1),
                         "c": f32(5, seed=2)}, alpha=0.5, beta=2.0,
                transA=1, transB=1),
    "Conv": one("Conv", {"x": f32(2, 4, 11), "c_w": f32(6, 2, 3, seed=1),
                         "c_b": f32(6, seed=2)}, group=2, dilations=[2],
                pads=[3, 1], strides=[2]),
    "Conv/2d_same": one("Conv", {"x": f32(1, 3, 7, 6),
                                 "c_w": f32(4, 3, 3, 2, seed=1)},
                        auto_pad="SAME_UPPER", strides=[2, 1]),
    "ConvTranspose": one("ConvTranspose", {"x": f32(2, 4, 6),
                                           "c_w": f32(4, 3, 4, seed=1),
                                           "c_b": f32(6, seed=2)},
                         group=2, strides=[2], pads=[1, 2]),
    "Reshape": one("Reshape", {"x": X, "c_s": i64(0, -1, 2)}),
    "Reshape/device_target": graph(
        [("Cast", ["sf"], ["s"], {"to": 7}),
         ("Reshape", ["x", "s"], ["y"])],
        {"x": X, "sf": np.asarray([4, 6], np.float32)}, ["y"]),
    "Slice": one("Slice", {"x": X, "c_st": i64(-1, BIG), "c_en": i64(-BIG, 0),
                           "c_ax": i64(2, 1), "c_sp": i64(-2, 1)}),
    "Slice/positive": one("Slice", {"x": X, "c_st": i64(1), "c_en": i64(BIG),
                                    "c_ax": i64(-1)}),
    "Concat": one("Concat", {"a": X, "b": Y}, axis=-1),
    "Gather": one("Gather", {"x": X, "c_i": np.asarray([[0, -1], [2, -3]],
                                                       np.int64)}, axis=2),
    "GatherElements": one("GatherElements", {
        "x": X, "i": np.asarray(ints(2, 3, 2, lo=-4, hi=4))}, axis=2),
    "Unsqueeze": one("Unsqueeze", {"x": X, "c_a": i64(-1, 0)}),
    "Squeeze": one("Squeeze", {"x": X[:, :1, None], "c_a": i64(1, 2)}),
    "Transpose": one("Transpose", {"x": X}, perm=[2, 0, 1]),
    "Cast": one("Cast", {"x": 3 * X}, to=7),
    "Cast/bool": one("Cast", {"x": np.asarray([0.0, -0.0, 2.0, -1.5],
                                              np.float32)}, to=9),
    "Constant": graph([("Constant", [], ["y"],
                        {"value": np.asarray([[1.5, -2.0]], np.float32)})],
                      {}, ["y"]),
    "ConstantOfShape": one("ConstantOfShape", {"c_s": i64(2, 3)},
                           value=np.asarray([7], np.int32)),
    "Expand": one("Expand", {"x": f32(3, 1), "c_s": i64(2, 1, 4)}),
    "Where": one("Where", {"c": BOOL_A, "a": f32(2, 5), "b": f32(5, seed=1)}),
    "Range": one("Range", {"a": np.int64(2), "b": np.int64(40),
                           "c": np.int64(3)}),
    "Range/float": one("Range", {"a": np.float32(0.5), "b": np.float32(3.0),
                                 "c": np.float32(0.75)}),
    "Tile": one("Tile", {"x": f32(2, 3), "c_r": i64(2, 3)}),
    "CumSum": one("CumSum", {"x": X, "c_a": np.int64(2)}, exclusive=1,
                  reverse=1),
    "CumSum/int": one("CumSum", {"x": ints(3, 4, dtype=np.int32),
                                 "c_a": np.int64(1)}),
    "ArgMax": one("ArgMax", {"x": ints(3, 6, lo=0, hi=3)}, axis=1,
                  select_last_index=1),
    "ArgMin": one("ArgMin", {"x": ints(3, 6, lo=0, hi=3)}, axis=1,
                  keepdims=0),
    "Clip": one("Clip", {"x": X, "lo": np.float32(-0.5), "": None}),
    "Split": one("Split", {"x": f32(2, 7)}, n_out=3, opset=18, axis=1,
                 num_outputs=3),
    "Split/sizes": one("Split", {"x": f32(2, 7), "c_s": i64(2, 5)}, n_out=2,
                       axis=1),
    "Pad": one("Pad", {"x": f32(2, 3, 4, 5), "c_p": i64(0, 1, -1, 3,
                                                        1, 2, 1, 4)},
               mode="reflect"),
    "Pad/edge": one("Pad", {"x": f32(2, 3, 4), "c_p": i64(0, 0, 5, 0, 2, 1)},
                    mode="edge"),
    "Pad/constant": one("Pad", {"x": f32(2, 3), "c_p": i64(1, -1, 0, 2),
                                "c_v": np.float32(1.25)}),
    "ReduceMean": one("ReduceMean", {"x": X, "c_a": i64(0, -1)}, opset=18),
    "ReduceSum": one("ReduceSum", {"x": X, "c_a": i64(1)}, keepdims=0),
    "ReduceSum/empty_axes": one("ReduceSum", {
        "x": ints(3, 4, dtype=np.int32), "c_a": np.zeros(0, np.int64)}),
    "ReduceMax": one("ReduceMax", {"x": X}, axes=[1], keepdims=0),
    "ReduceMin": one("ReduceMin", {"x": X}),
    "ReduceProd": one("ReduceProd", {"x": ints(2, 3, 4, lo=1, hi=4)},
                      axes=[0, 2]),
    "LayerNormalization": one("LayerNormalization", {
        "x": X, "c_s": f32(4, seed=3), "c_b": f32(4, seed=4)},
        epsilon=1e-4),
    "LSTM": _lstm_case(),
    "GRU": _gru_case("reverse", 0),
    "GRU/bidirectional": _gru_case("bidirectional", 1),
    "QuantizeLinear": one("QuantizeLinear", {
        "x": 40 * X, "c_s": np.asarray([0.2, 0.5, 0.9], np.float32),
        "c_z": np.asarray([-3, 0, 7], np.int8)}, axis=1),
    "DequantizeLinear": one("DequantizeLinear", {
        "x": ints(3, 4, lo=0, hi=256, dtype=np.uint8),
        "c_s": np.asarray([0.013, 0.2, 0.7, 1.1], np.float32),
        "c_z": np.asarray([3, 128, 0, 255], np.uint8)}, axis=1),
    "DynamicQuantizeLinear": one("DynamicQuantizeLinear", {"x": 3 * X},
                                 n_out=3),
    "MatMulInteger": one("MatMulInteger", {
        "a": ints(3, 8, lo=0, hi=256, dtype=np.uint8),
        "b": ints(8, 5, lo=-128, hi=128, seed=1, dtype=np.int8),
        "az": np.uint8(131), "bz": ints(5, lo=-4, hi=4, dtype=np.int8)}),
    "QLinearMatMul": one("QLinearMatMul", {
        "a": ints(3, 8, lo=0, hi=256, dtype=np.uint8),
        "as": np.float32(0.02), "az": np.uint8(120),
        "b": ints(8, 5, lo=-128, hi=128, seed=1, dtype=np.int8),
        "bs": np.float32(0.013), "bz": np.int8(-2),
        "ys": np.float32(0.05), "yz": np.uint8(110)}),
    "ConvInteger": one("ConvInteger", {
        "x": _quant_conv_inputs()[0], "w": _quant_conv_inputs()[1],
        "xz": np.uint8(128)}, group=2, pads=[1, 0, 0, 1], strides=[2, 1]),
    "QLinearConv": one("QLinearConv", {
        "x": _quant_conv_inputs()[0], "xs": np.float32(0.03),
        "xz": np.uint8(128), "w": _quant_conv_inputs()[1],
        "ws": np.asarray([0.01, 0.02, 0.005, 0.03, 0.02, 0.01], np.float32),
        "wz": np.zeros(6, np.int8), "ys": np.float32(0.2),
        "yz": np.int8(3), "b": ints(6, lo=-300, hi=300, dtype=np.int32)},
        group=2, dilations=[2, 1]),
    "ScatterND": one("ScatterND", {
        "x": f32(4, 3), "c_i": np.asarray([[0], [-2], [0]], np.int64),
        "u": f32(3, 3, seed=1)}, reduction="add"),
    "ScatterND/plain": one("ScatterND", {
        "x": f32(4, 3, 2), "c_i": np.asarray([[1, 2], [3, -1]], np.int64),
        "u": f32(2, 2, seed=1)}),
    "ScatterElements": one("ScatterElements", {
        "x": f32(3, 4), "i": np.asarray([[0, -1], [2, 1], [1, 1]], np.int64),
        "u": f32(3, 2, seed=2)}, axis=1, reduction="mul"),
    "GatherND": one("GatherND", {
        "x": f32(2, 3, 4), "i": np.asarray([[[1, -1]], [[-3, 0]]], np.int64)},
        batch_dims=1),
    "NonZero": one("NonZero", {"x": ints(3, 4, lo=0, hi=2)}),
    "TopK": one("TopK", {"x": ints(3, 7, lo=0, hi=3).astype(np.float32),
                         "c_k": i64(4)}, n_out=2, axis=1),
    "TopK/smallest": one("TopK", {"x": ints(7, 3, lo=0, hi=3).astype(
        np.float32), "c_k": i64(2)}, n_out=2, axis=0, largest=0),
    "OneHot": one("OneHot", {"i": np.asarray([[0, -1], [3, 2]], np.int64),
                             "c_d": np.int64(5),
                             "v": np.asarray([0.25, 2.0], np.float32)},
                  axis=1),
    "ReverseSequence": one("ReverseSequence", {
        "x": f32(5, 3, 2), "l": np.asarray([5, 0, 3], np.int64)}),
    "Trilu": one("Trilu", {"x": f32(2, 4, 5), "c_k": np.int64(1)}),
    "Trilu/lower": one("Trilu", {"x": f32(4, 5), "c_k": np.int64(-1)},
                       upper=0),
    "If/then": _if_case(True),
    "If/else": _if_case(False),
    "Loop": _loop_case(3),
    "Loop/zero_trips": _loop_case(0),
    "Loop/condition": _loop_cond_case(),
    "RandomNormalLike": graph(
        [("RandomNormalLike", ["x"], ["n"], {"scale": 0.5, "mean": 0.1}),
         ("Add", ["n", "x"], ["y"]),
         ("RandomNormalLike", ["y"], ["m"], {}),
         ("Mul", ["m", "y"], ["z"])], {"x": X}, ["y", "z"]),
}


def _models(case, tmp_path):
    path = tmp_path / "case.onnx"
    feeds = {k: v for k, v in case["feeds"].items() if v is not None}
    write_onnx(str(path), case["inits"], inputs=list(case["feeds"]),
               outputs=case["outputs"], nodes=case["nodes"],
               opset=case["opset"])
    return jax_read_onnx(str(path)), read_onnx(str(path)), feeds


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_jax_interpreter(name, tmp_path):
    jax_model, port_model, feeds = _models(CASES[name], tmp_path)
    executor = OnnxExecutor(jax_model)
    runner = TorchGraphRunner(port_model, device="cpu")
    executor.reseed(5)
    runner.executor.reseed(5)
    want = executor.run(feeds)
    got = runner.run(feeds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    # floats and data stay off the host: host values are small integers
    for op, node, dtype, numel in runner.last_run.host_outputs:
        assert np.dtype(dtype).kind in "biu", (name, op, node)
        assert numel <= torch_lowering.HOST_MAX, (name, op, node)


def test_cases_cover_the_op_table():
    from phoonnx_tpu_torch.onnx.executor import _OPS

    assert set(torch_lowering._TORCH_OPS) == set(_OPS)
    covered = {name.split("/")[0] for name in CASES}
    wanted = set(_OPS) | set(torch_lowering.CONTROL_OPS)
    assert covered == wanted, sorted(covered ^ wanted)
    assert {"Softmax/legacy", "LogSoftmax/legacy"} <= set(CASES)


def test_device_reads_are_counted(tmp_path):
    """A shape slot fed from a device value reads it once; one fed from
    the host's shape arithmetic reads nothing."""
    _, model, feeds = _models(CASES["Reshape/device_target"], tmp_path)
    runner = TorchGraphRunner(model, device="cpu")
    runner.run(feeds)
    assert dict(runner.last_run.reads) == {"Reshape": 1}
    _, model, feeds = _models(CASES["Reshape"], tmp_path)
    runner = TorchGraphRunner(model, device="cpu")
    runner.run(feeds)
    assert not runner.last_run.reads


def test_unknown_op_raises_naming_it(tmp_path):
    case = one("NoSuchOp", {"x": X})
    case["nodes"][0] = ("NoSuchOp", ["x"], ["y0"], {})
    _, model, feeds = _models(case, tmp_path)
    with pytest.raises(NotImplementedError, match="'NoSuchOp'"):
        TorchGraphRunner(model, device="cpu").run(feeds)
