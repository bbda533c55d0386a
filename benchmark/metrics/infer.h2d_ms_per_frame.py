"""infer.h2d_ms_per_frame: device ms of host-to-device copies a real frame
of a pass: the copies' time in the profiled window, a whole pass, over its
real frames (padding frames are copied too, so padding shows here)."""

from benchmark.lib.groups import MEMCPY_HTOD


def read(r):
    if r.kind != "infer" or r.device is None:
        return None
    us = sum(e - s for name, s, e in r.device["events"] if MEMCPY_HTOD in name)
    if not us:
        return None
    return us / 1e3 / r.device["per"]["work"]
