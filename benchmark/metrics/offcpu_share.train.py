"""Per cent of the training thread's own host work in the step spent off a
CPU (waiting for the interpreter's lock, which the loader's producer
thread may hold, for the scheduler, or for the card where the host reads
it), in the traced window's session: 1 less the sum of self CPU ms over
the sum of self wall ms of the ``train.*`` spans, but for the backward
passes (``train.gen_backward``, ``train.disc_backward``), in which
``torch.autograd.grad`` hands the graph to autograd's own thread for the
card and waits."""
from phoonnx_tpu_torch import observability

WAITS = ("train.gen_backward", "train.disc_backward")


def read(r):
    session = getattr(observability, "session", None)
    if session is None:
        return None
    spans = [s for name, s in session()["spans"].items()
             if name.startswith("train.") and name not in WAITS]
    wall = sum(s["self_wall_ms"] for s in spans)
    cpu = sum(s["self_cpu_ms"] for s in spans)
    return 100.0 * (1.0 - cpu / wall) if wall > 0 else None
