"""Per cent of the traced window's busy device time spent in the head of
a multi-band iSTFT decoder (the magnitude and phase convs, the inverse
DFT, the overlap-add and the PQMF bank). The head's operations are found
by place, not by name (``harness/serve_istft.py`` ``head_seconds``): in
each phase-2 graph replay (the device operations that share its launch's
correlation id and hold a kernel-C operation), those that start after
the end of its last kernel-C operation. ``istft_head_s`` and
``istft_busy_s`` are their seconds and the device's busy seconds inside
the window."""


def read(r):
    head = r.counters.get("istft_head_s")
    busy = r.counters.get("istft_busy_s")
    return 100.0 * head / busy if head and busy else None
