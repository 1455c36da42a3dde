"""Requests answered in the traced window over device dispatches (phase-1
graph replays and captures): how full the batcher keeps a dispatch."""


def read(r):
    d = r.counters.get("dispatches")
    return r.counters["requests_done"] / d if d else None
