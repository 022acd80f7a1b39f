"""Rays cast by every inverse-rendering step of the window, over the
window's wall time (the reference's counter: one per bounce-loop
iteration entered per pixel sample)."""
from benchmark import stats


def read(r):
    if r.loop != "fwdbwd":
        return None
    return stats.rate(r.rays, r.window_s)
