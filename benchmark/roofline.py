"""Peaks of the card and the work counts of the kernels the benchmark
prices, frozen here so that a change to the program cannot move them.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity):
67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM3, at the
full 700 W power limit.

K3 (the regen backward, ``regen_bwd_kernel`` and its partial-sum
launches): 550 fp32 operations an alive lane-step, one lane-step per
ray cast (the count of the repo's ``chip_smoke.py``, from
``csrc/regen_step.cuh`` trt_step_tail's replay ~107 and ``regen_bwd.cu``'s
primal recompute ~139, transpose ~237 and the regenerated ray's camera
transpose ~73, rounded down). Its bytes are what the inputs fix, each
read or written once: the colour cotangent in (12 B a lane), the primary
origin and direction cotangents out (24 B a lane), the winner table in
and its gradient out (48 B a row each), the camera rows in (52 B) and
their gradient out (48 B). Nothing is priced by the kernel's own
counters or by its records' layout, which a later design may change.
"""
from __future__ import annotations

PEAK_F32 = 67e12          # flop/s
PEAK_BYTES = 3.35e12      # bytes/s

K3_FLOPS_PER_RAY = 550


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the work takes at the peaks: the larger of its operations
    over the fp32 peak and its bytes over the memory rate."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


def k3_work(rays: int, lanes: int, table_rows: int):
    """(flops, bytes) of one K3 call over ``rays`` rays cast by ``lanes``
    lanes on a winner table of ``table_rows`` rows."""
    flops = K3_FLOPS_PER_RAY * rays
    nbytes = (12 + 24) * lanes + 2 * 48 * table_rows + 52 + 48
    return flops, nbytes


def k3_least_time(rays: int, lanes: int, table_rows: int) -> float:
    return least_time(*k3_work(rays, lanes, table_rows))
