"""Kernel C (the decoder's resblock groups and conv_post tail): the least
time of the window's stage work at the answered requests' true frames over
the device time of the kernels that match kernels/C/*.json, per cent."""
from harness.readers import roofline, stage_work


def read(r):
    return roofline(r, "C", stage_work)
