"""Per cent of the frames the card decoded that belong to real lanes, over
the traced window's ``batcher.dispatch`` spans: the sum of their
``frames_real`` over the sum of their ``frames_decoded`` (lanes times the
frame bucket, pad lanes included)."""
from phoonnx_tpu_torch import observability


def read(r):
    session = getattr(observability, "session", None)
    s = session()["spans"].get("batcher.dispatch") if session else None
    decoded = s["args"].get("frames_decoded") if s else None
    return 100.0 * s["args"]["frames_real"] / decoded if decoded else None
