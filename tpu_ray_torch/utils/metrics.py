"""Step timing, JSONL metrics and profiling (port of
``tpu_ray/utils/metrics.py``).

Every timing ends in ``torch.cuda.synchronize()`` when the work runs on
the card: PyTorch returns before the device finishes, so a host clock
without it measures the enqueue.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import IO, Optional

import torch
from torch.utils._pytree import tree_leaves


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def hard_timeit(step, *args, iters: int = 3) -> float:
    """Wall seconds per step(*args) over ``iters`` calls after one warm-up
    call, each edge ending in a device synchronize and a hard host fetch
    (``.cpu()``) of the output's first tensor, which the device cannot
    finish after. Keep the output small (a scalar or a gradient tree)."""
    def fetch(out):
        _sync()
        first = next((x for x in tree_leaves(out)
                      if isinstance(x, torch.Tensor)), None)
        if first is not None:
            first.detach().cpu()

    fetch(step(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(*args)
    fetch(out)
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Wall-time a computation, device-synchronised on both edges."""

    @staticmethod
    def timed(fn, *args):
        """Run fn(*args) -> (result, seconds)."""
        _sync()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        return out, time.perf_counter() - t0


class MetricsLogger:
    """JSONL metrics stream: one JSON object per line."""

    def __init__(self, stream: Optional[IO] = None,
                 path: Optional[str] = None):
        self._own = open(path, "a") if path is not None else None
        self.stream = self._own or stream or sys.stdout

    def log(self, **record) -> dict:
        record.setdefault("ts", time.time())
        self.stream.write(json.dumps(record) + "\n")
        self.stream.flush()
        return record

    def log_pass(self, *, rays: int, seconds: float, **extra) -> dict:
        """One progressive pass: rays cast, its seconds, rays per second
        and nanoseconds per ray (the reference's stats panel)."""
        return self.log(
            rays_cast=int(rays),
            seconds=round(seconds, 6),
            rays_per_s=round(rays / seconds, 1) if seconds > 0 else None,
            ns_per_ray=round(seconds / rays * 1e9, 3) if rays else None,
            **extra)

    def close(self):
        if self._own is not None:
            self._own.close()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (the host, and the card when
    there is one), its Chrome trace written into ``log_dir``
    (``<host>_<pid>.<ms>.pt.trace.json``); a no-op when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
