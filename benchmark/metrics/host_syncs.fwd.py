"""Host syncs a progressive pass over the traced stretch
(``host_syncs.fwdbwd``'s counter and reading)."""
from benchmark import harness

_step = harness.load_reader("host_syncs.fwdbwd")
PATHS, COUNTERS = _step.PATHS, _step.COUNTERS


def read(r):
    return _step.per_step(r) if r.loop == "pass" else None
