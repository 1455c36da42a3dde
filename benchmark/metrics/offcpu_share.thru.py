"""Per cent of the dispatcher thread's host work spent off a CPU (waiting
for the interpreter's lock or the scheduler), in the traced window's
session: 1 less the sum of self CPU ms over the sum of self wall ms of
its spans, but for its waits for the card (``engine.frames``,
``engine.fetch``)."""
from phoonnx_tpu_torch import observability

# DynamicBatcher's thread
DISPATCHER = "phoonnx-batcher"
WAITS = ("engine.frames", "engine.fetch")


def read(r):
    session = getattr(observability, "session", None)
    if session is None:
        return None
    spans = [s for name, s in session(DISPATCHER)["spans"].items()
             if name not in WAITS]
    wall = sum(s["self_wall_ms"] for s in spans)
    cpu = sum(s["self_cpu_ms"] for s in spans)
    return 100.0 * (1.0 - cpu / wall) if wall > 0 else None
