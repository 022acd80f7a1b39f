"""The numbers that decide ``correct``: each a distance between what the
timed path produced and what the plain reference computes, held to the
cell's limit (``cells/<workload>.json`` ``"limits"``; the readings each
was set from are in ``PERF.md``)."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

import torch


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref||, in f64."""
    got = got.detach().to(torch.float64)
    ref = ref.detach().to(torch.float64)
    den = float(torch.linalg.vector_norm(ref))
    num = float(torch.linalg.vector_norm(got - ref))
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def rel_gap(got: float, ref: float) -> float:
    """|got - ref| / |ref| of two counts."""
    if ref == 0:
        return 0.0 if got == 0 else math.inf
    return abs(float(got) - float(ref)) / abs(float(ref))


def leaf_gaps(got: Dict[str, Optional[torch.Tensor]],
              ref: Dict[str, Optional[torch.Tensor]]) -> Dict[str, float]:
    """Each leaf's ||g - g_ref|| over the larger of ||g_ref|| and the
    median leaf's ||g_ref||: a leaf whose gradient is all but zero is
    measured against the median leaf. A leaf the program left
    without a gradient counts as zeros; a leaf the program lacks counts as
    missing (infinitely far)."""
    def as64(t, like):
        return (torch.zeros_like(like, dtype=torch.float64) if t is None
                else t.detach().to(torch.float64))
    refs = {k: as64(v, v) if v is not None else None for k, v in ref.items()}
    refs = {k: v for k, v in refs.items() if v is not None}
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in refs.items()}
    med = statistics.median(norms.values())
    out = {}
    for k, r in refs.items():
        if k not in got:
            out[k] = math.inf
            continue
        g = as64(got[k], r).to(r.device)
        den = max(norms[k], med)
        num = float(torch.linalg.vector_norm(g - r))
        out[k] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def entries_off(got: Dict[str, Optional[torch.Tensor]],
                ref: Dict[str, Optional[torch.Tensor]],
                rtol: float = 1e-3, floor: float = 1e-4) -> float:
    """Of the gradient entries that matter on either side (past ``floor``
    of the leaf's largest reference entry), over every leaf, the share
    that differ from the reference's by more than rtol of the entry plus
    that floor. A few lanes that take another path change the few entries
    their primitives own; a wrong gradient changes most, and a gradient
    left at zero reads 1."""
    off = seen = 0
    for k, r in ref.items():
        if r is None:
            continue
        r = r.detach().to(torch.float64)
        g = got.get(k)
        g = torch.zeros_like(r) if g is None else g.detach().to(
            torch.float64).to(r.device)
        small = floor * float(r.abs().max())
        matter = (r.abs() > small) | (g.abs() > small)
        off += int((matter & ((g - r).abs() > rtol * r.abs() + small)).sum())
        seen += int(matter.sum())
    return off / seen if seen else 0.0


def fold(mean, n: int, batch_sum, k: int):
    """The program's running mean (mean * n + batch_sum) / (n + k), in its
    f32 op order."""
    total = torch.tensor(float(n + k), dtype=mean.dtype, device=mean.device)
    return torch.div(mean * float(n) + batch_sum, total)


def judge(got: Dict[str, float], limits: Dict[str, float]):
    """-> (correct, {name: {"value", "limit"}}) over the numbers the cell
    has limits for (every one of them must be computed). A number that is
    not finite fails."""
    checks = {}
    ok = True
    for name in limits:
        value, limit = got[name], float(limits[name])
        checks[name] = {"value": float(value), "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
