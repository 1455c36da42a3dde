"""Kernel B (the inverse coupling flow): the least time of the window's
flow work at the answered requests' true frames over the device time of
the kernels that match kernels/B/*.json, per cent."""
from harness.readers import flow_work, roofline


def read(r):
    return roofline(r, "B", flow_work)
