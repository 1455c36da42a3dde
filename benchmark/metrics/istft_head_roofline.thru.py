"""The head of a multi-band iSTFT decoder against its roofline: the least
time of its work at the answered requests' true frames (operations at the
card's peak or bytes at its bandwidth, the larger; the head's weights
counted once an ``engine.phase2`` span of the program's session) over the
device seconds of the head's operations, per cent. The operations are
found by place, as ``istft_head_share.thru`` finds them
(``harness/serve_istft.py`` ``head_seconds``: in each phase-2 graph
replay, those after its last kernel-C operation); their seconds are the
counter ``istft_head_s``."""
from harness import flops, flops_istft
from harness import peaks as peaks_mod
from phoonnx_tpu_torch import observability


def read(r):
    spent = r.counters.get("istft_head_s")
    reqs = r.counters.get("requests")
    session = getattr(observability, "session", None)
    if not spent or not reqs or r.peaks is None or session is None:
        return None
    phase2 = session()["spans"].get("engine.phase2")
    if not phase2:
        return None
    cfg = r.cell.config
    fl = sum(flops_istft.head(cfg, frames) for _, frames in reqs)
    nb = (sum(flops_istft.head_bytes(cfg, frames) for _, frames in reqs)
          + phase2["count"] * flops_istft.head_weight_bytes(cfg))
    least = flops.least_seconds(
        fl, nb, peaks_mod.flops_peak(r.peaks, cfg["dtype"]),
        r.peaks["bytes"])
    return 100.0 * least / spent
