"""Mean wall ms of the program's ``engine.prior`` spans in the traced
window's session: the host's draw of a dispatch's prior noise between
its two phases."""
from phoonnx_tpu_torch import observability


def read(r):
    session = getattr(observability, "session", None)
    s = session()["spans"].get("engine.prior") if session else None
    return s["wall_ms"] / s["count"] if s else None
