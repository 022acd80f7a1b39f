"""MiB copied from host to card a step over the traced stretch: the bytes
of the program's blocking copies to the card (``to_device`` in
``tpu_ray_torch/utils/metrics.py``, ``TRANSFERS.htod_bytes``), from
pageable memory. Counted in the traced run, whose host is slowed by the
profiler; the bytes are the same untraced. None where the program has no
such counter."""
from benchmark import harness

PATHS = ("tpu_ray_torch.utils.metrics:TRANSFERS.htod_bytes",)


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
    return r.launches[COUNTERS[0]] / 2 ** 20 / r.trace_steps


def read(r):
    return per_step(r) if r.loop == "fwdbwd" else None
