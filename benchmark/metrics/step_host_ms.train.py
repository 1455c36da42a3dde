"""Mean wall ms of the program's ``train.step`` spans in the traced
window's session: one ``train_step`` call on the host, which returns
before the card has run what it launched."""
from phoonnx_tpu_torch import observability


def read(r):
    session = getattr(observability, "session", None)
    s = session()["spans"].get("train.step") if session else None
    return s["wall_ms"] / s["count"] if s else None
