"""Host ms a step in the regen route's stages over the traced stretch:
the self time of the program's spans ``tile_order``, ``regen_tables``,
``search_tables``, ``wave_init``, ``regen_forward``, ``regen_backward``
and ``untile`` (``tpu_ray_torch/utils/metrics.py``), so nested stages and
the host's waits on the device (the ``wait`` span) are left out. The
times are host-clock times taken while the profiler records, so higher
than the same stages untraced. None where the program has no such spans."""
from benchmark import harness

STAGES = ("tile_order", "regen_tables", "search_tables", "wave_init",
          "regen_forward", "regen_backward", "untile")
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


def per_step(r):
    if r.trace is None or not COUNTERS or not r.trace_steps:
        return None
    return 1e-6 * sum(r.launches[c] for c in COUNTERS) / r.trace_steps


def read(r):
    return per_step(r) if r.loop == "fwdbwd" else None
