"""The bundled auxiliary ONNX models on a torch device.

Port of ``phoonnx_tpu/onnx/aux_compile.py``. The reference runs its
auxiliary models (libtashkeel's diacritizer, phonikud) on onnxruntime
(reference phoonnx/thirdparty/tashkeel/__init__.py,
phonikud/__init__.py); the port runs them op by op on the diacritizer's
device through :class:`phoonnx_tpu_torch.onnx.torch_lowering.TorchGraphRunner`,
the runner that carries foreign voices.

**Length bucketing** is kept: callers pad a text-shaped input to a
:func:`bucket_len` bucket and slice the outputs back, as the JAX package
does to bound its compile count. The runner compiles nothing, but the
buckets keep the shapes a later captured graph would key on to a handful,
and they are sound only for models that mask by an explicit length input
(``input_lengths``, ``attention_mask``), which callers check once a
process against an exact-length run on the same runner (see
``TashkeelDiacritizer._infer``).

Not ported, deliberately: the ``PHOONNX_AUX_COMPILE=0`` opt-out and the
JAX function's "returns None, callers keep the interpreter" contract.
The port has no interpreter fallback on its device path: a model runs on
the runner, and a runner failure raises.
"""

from typing import Optional

# Generous step ladder: ~1.3-2x growth keeps both the compile count and
# the padding waste (host-side; the models are tiny) bounded.
AUX_LEN_BUCKETS = (16, 32, 64, 128, 192, 256, 384, 512, 768, 1024,
                   1536, 2048, 3072, 4096, 6144, 8192, 12288)


def bucket_len(n: int, buckets=AUX_LEN_BUCKETS) -> int:
    """Smallest bucket >= n; lengths beyond the ladder stay exact
    (correct, just compiled per length — callers cap input sizes long
    before that)."""
    for b in buckets:
        if n <= b:
            return b
    return n


def compiled_runner(model, device=None,
                    matmul_precision: Optional[str] = None):
    """A :class:`TorchGraphRunner` for ``model`` on ``device`` (None means
    the GPU, and raises without one; ``"cpu"`` runs the same ops on the
    host's torch)."""
    from phoonnx_tpu_torch.onnx.torch_lowering import TorchGraphRunner

    return TorchGraphRunner(model, device=device,
                            matmul_precision=matmul_precision)
