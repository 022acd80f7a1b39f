"""95th percentile of the wall time of every inverse-rendering step of
the window, in ms: the latency of one fit iteration."""
from benchmark import stats


def read(r):
    if r.loop != "fwdbwd":
        return None
    return 1e3 * stats.percentile(r.step_s, 95)
