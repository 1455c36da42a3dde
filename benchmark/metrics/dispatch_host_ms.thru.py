"""Mean host ms of one VitsEngine.synthesize_batch call, less its waits for
the card in _ready: the dispatcher's own work a dispatch."""
from harness.readers import mean_of


def read(r):
    return mean_of(r, "dispatch_host_ms")
