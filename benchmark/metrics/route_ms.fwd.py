"""Host ms a progressive pass in the regen route's stages over the traced
stretch (``route_ms.fwdbwd``'s spans and reading: their self time, taken
while the profiler records, so higher than untraced)."""
from benchmark import harness

_step = harness.load_reader("route_ms.fwdbwd")
PATHS, COUNTERS = _step.PATHS, _step.COUNTERS


def read(r):
    return _step.per_step(r) if r.loop == "pass" else None
