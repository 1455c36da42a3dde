"""Mean wall ms of the program's ``batcher.reassemble`` spans in the traced
window's session: a group's scatter back into request order, the
concatenation of each request's audio and the waking of its handler."""
from phoonnx_tpu_torch import observability


def read(r):
    session = getattr(observability, "session", None)
    s = session()["spans"].get("batcher.reassemble") if session else None
    return s["wall_ms"] / s["count"] if s else None
