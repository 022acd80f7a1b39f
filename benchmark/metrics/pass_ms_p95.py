"""95th percentile of the wall time of the window's progressive passes,
in ms, the traced stretch left out."""
from benchmark import stats


def read(r):
    if r.loop != "pass" or not r.host_step_s:
        return None
    return 1e3 * stats.percentile(r.host_step_s, 95)
