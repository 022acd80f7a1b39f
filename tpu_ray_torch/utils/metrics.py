"""Step timing, JSONL metrics and profiling (port of
``tpu_ray/utils/metrics.py``), and the host spans and host-device
counters of the regen route and the probe route.

Every timing ends in ``torch.cuda.synchronize()`` when the work runs on
the card: PyTorch returns before the device finishes, so a host clock
without it measures the enqueue.

``span(name)`` times a stage of the route on the host; ``to_device`` and
``to_host`` are the route's blocking copies and reads, counted in
``TRANSFERS``. All are always on (two clock reads a span), and are read
as plain int attributes, as the kernels' launch counters are:
``SPANS.<name>.calls``, ``.ns`` and ``.self_ns``;
``TRANSFERS.host_syncs`` and ``.htod_bytes``.
"""
from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from types import SimpleNamespace
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


class SpanCounts:
    """One span name's record: the spans closed, their total host ns, and
    their self ns (each span's duration less what its child spans on the
    same thread covered)."""
    __slots__ = ("calls", "ns", "self_ns")

    def __init__(self):
        self.calls = self.ns = self.self_ns = 0


# Every span the program opens (a name outside this list raises):
# render_mean (``grad.render_mean``) and pass (``PathTracer.step``, with
# accumulate its child) name the benchmark's idle gaps; the route's stages
# tile_order, regen_tables, search_tables, wave_init, regen_forward,
# regen_backward and untile are summed by the benchmark's ``route_ms``;
# the probe route's forward stages probe_tables, ray_sort, sphere_search,
# tri_search, payload and shade by its ``probe_ms``; wait is the host
# blocked in ``to_device``/``to_host``.
SPANS = SimpleNamespace(**{name: SpanCounts() for name in (
    "render_mean", "pass", "accumulate", "tile_order", "regen_tables",
    "search_tables", "wave_init", "regen_forward", "regen_backward",
    "untile", "probe_tables", "ray_sort", "sphere_search", "tri_search",
    "payload", "shade", "wait")})


class TransferCounts:
    """Blocking host-device transfers: each ``to_device`` to the card and
    ``to_host`` from it is one host sync; htod_bytes sums the bytes that
    ``to_device`` copied to the card."""
    __slots__ = ("host_syncs", "htod_bytes")

    def __init__(self):
        self.host_syncs = self.htod_bytes = 0


TRANSFERS = TransferCounts()
# a span's profiler event is "tpu_ray_torch.<name>"
EVENT_PREFIX = __name__.split(".")[0] + "."
_counts_lock = threading.Lock()
# .stack: for each span open on this thread, [ns its child spans covered]
_open = threading.local()


class span:
    """``with span(name):`` adds the block's host time to ``SPANS.<name>``
    and, while a ``torch.profiler`` records, also opens
    ``record_function(EVENT_PREFIX + name)``, so the span sits on the
    profiler's clock beside the device's events."""
    __slots__ = ("counts", "name", "t0", "covered", "annotation")

    def __init__(self, name: str):
        self.counts = getattr(SPANS, name)
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.covered = [0]
        stack.append(self.covered)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(
                EVENT_PREFIX + self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1][0] += ns
        c = self.counts
        with _counts_lock:
            c.calls += 1
            c.ns += ns
            c.self_ns += ns - self.covered[0]
        return False


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(data, dtype=dtype, device=device)`` of host data
    (an array, a list, a number). To the card it is a copy from pageable
    memory that blocks the host until the stream reaches it: counted in
    ``TRANSFERS`` (its bytes as copied, in dtype) and timed as a wait."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.as_tensor(data, dtype=dtype, device=device)
    with span("wait"):
        out = torch.as_tensor(data, dtype=dtype, device=device)
    with _counts_lock:
        TRANSFERS.host_syncs += 1
        TRANSFERS.htod_bytes += out.numel() * out.element_size()
    return out


def to_host(t: torch.Tensor, read):
    """``read(t)``: a read of tensor t on the host (``int``, ``float``,
    ``torch.Tensor.tolist``, a copy to the CPU). Where t is on the card the
    host waits for the device's work up to it: counted as a host sync in
    ``TRANSFERS`` and timed as a wait."""
    if not t.is_cuda:
        return read(t)
    with span("wait"):
        out = read(t)
    with _counts_lock:
        TRANSFERS.host_syncs += 1
    return out
