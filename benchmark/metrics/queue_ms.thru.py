"""Mean wall ms of the program's ``batcher.queue`` spans in the traced
window's session: a request's wait from ``DynamicBatcher.submit`` to the
start of the group that serves it."""
from phoonnx_tpu_torch import observability


def read(r):
    session = getattr(observability, "session", None)
    s = session()["spans"].get("batcher.queue") if session else None
    return s["wall_ms"] / s["count"] if s else None
