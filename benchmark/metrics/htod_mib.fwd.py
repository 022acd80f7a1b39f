"""MiB copied from host to card a progressive pass over the traced
stretch (``htod_mib.fwdbwd``'s counter and reading)."""
from benchmark import harness

_step = harness.load_reader("htod_mib.fwdbwd")
PATHS, COUNTERS = _step.PATHS, _step.COUNTERS


def read(r):
    return _step.per_step(r) if r.loop == "pass" else None
