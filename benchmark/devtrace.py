"""Reading a ``torch.profiler`` trace of a stretch of the window.

The profiler's Chrome trace (``export_chrome_trace``) is read as JSON:
device events are those of the categories in ``DEVICE_CATS`` (kernels,
copies, memsets), host events the CPU operators and the harness's own
``record_function`` spans. ``summarize`` reduces it to what the per-layer
readers take: device seconds by kernel name, the union of device busy
time, the stretch's length, the longest idle gaps named by what the host
was doing halfway through each, and the device operations that took the
most time.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
SPAN_PREFIX = "bench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds(self, names) -> float:
        """Device seconds of the kernels whose name contains one of names."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])
        return [[k, s] for k, s in ops[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, its anonymous namespace
    and its argument list, at most 160 characters."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return ("".join(out).strip() or name)[:160]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi] outside the union of intervals."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if b <= cur:
            continue
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _host_name(host, t: float) -> str:
    """What the host was doing at time t: the innermost harness span and
    the innermost operator that contain t."""
    inside = [e for e in host if e[0] <= t < e[1]]
    if not inside:
        return "host: outside any operator"
    spans = [e for e in inside if e[2].startswith(SPAN_PREFIX)]
    ops = [e for e in inside if not e[2].startswith(SPAN_PREFIX)]
    span = min(spans, key=lambda e: e[1] - e[0])[2] if spans else "host"
    if not ops:
        return span
    return f"{span} > {min(ops, key=lambda e: e[1] - e[0])[2]}"


def summarize(events: List[dict], lo_us: float, hi_us: float,
              top_gaps: int = 10) -> TraceSummary:
    """Reduce Chrome-trace events to the stretch [lo_us, hi_us] (the trace's
    microseconds)."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b <= lo_us or a >= hi_us:
            continue
        a, b = max(a, lo_us), min(b, hi_us)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((a, b, short_name(e.get("name", "?"))))
        elif cat in HOST_CATS:
            host.append((a, b, e.get("name", "?")))
    kernel_s: Dict[str, float] = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
    spans = [(a, b) for a, b, _ in dev]
    idle = sorted(gaps(spans, lo_us, hi_us), key=lambda g: g[0] - g[1])
    named = [[_host_name(host, (a + b) / 2), (b - a) * 1e-6]
             for a, b in idle[:top_gaps]]
    return TraceSummary(window_s=(hi_us - lo_us) * 1e-6,
                        busy_s=union_length(spans) * 1e-6,
                        kernel_s=kernel_s, idle_gaps=named)


def load(path: str) -> List[dict]:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def span_bounds(events: List[dict], name: str) -> Tuple[float, float]:
    """[first start, last end] in trace microseconds of the host spans
    called name (the harness's per-step spans)."""
    got = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("name") == name and "dur" in e]
    if not got:
        raise RuntimeError(f"the trace holds no {name!r} span")
    return min(a for a, _ in got), max(b for _, b in got)
