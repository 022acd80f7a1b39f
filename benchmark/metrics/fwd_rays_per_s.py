"""Rays cast by every progressive pass of the window, over the window's
wall time."""
from benchmark import stats


def read(r):
    if r.loop != "pass":
        return None
    return stats.rate(r.rays, r.window_s)
