"""Host ms a step in the probe route's forward stages over the traced
stretch: the self time of the program's spans ``probe_tables``,
``ray_sort``, ``sphere_search``, ``tri_search``, ``payload`` and
``shade`` (``tpu_ray_torch/utils/metrics.py``), so the host's waits on
the device (the ``wait`` span) are left out. Host-clock times taken while
the profiler records, so higher than the same stages untraced. None where
the program has no such spans."""
from benchmark import harness

STAGES = ("probe_tables", "ray_sort", "sphere_search", "tri_search",
          "payload", "shade")
PATHS = tuple(f"tpu_ray_torch.utils.metrics:SPANS.{s}.self_ns"
              for s in STAGES)


def _present(paths):
    """paths, or () where the program does not have them all."""
    try:
        for p in paths:
            harness.counter(p)
    except (ImportError, AttributeError):
        return ()
    return paths


COUNTERS = _present(PATHS)


def read(r):
    if (r.loop != "fwdbwd" or r.trace is None or not COUNTERS
            or not r.trace_steps):
        return None
    return 1e-6 * sum(r.launches[c] for c in COUNTERS) / r.trace_steps
