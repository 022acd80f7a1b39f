"""K7: nearest triangle hit per ray, the CUDA kernel ``csrc/tri_intersect.cu``.

Replaces ``tpu_ray/kernels/tri_intersect.py::nearest_hit_tri_pallas``. Its
plain version is ``ops/intersect_tri.nearest_hit_tri``: the wrapper takes
it for CPU tensors only; for CUDA tensors it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.kernels import build
from tpu_ray_torch.ops.intersect import Hit
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri as tri_hit_plain

__all__ = ["tri_nearest_hit", "tri_hit_plain"]


def tri_nearest_hit(tab, origin, direction) -> Hit:
    """tab: the triangles' ``tri_search_table`` [M,9] f32; origin/direction
    [R,3] f32 -> Hit(t [R] f32, idx [R] i32): the exact nearest
    Möller-Trumbore hit, lowest index on ties. Neither output carries
    autograd history (the search is a discrete choice)."""
    if not origin.is_cuda:
        return tri_hit_plain(tab, origin, direction)
    m, r = tab.shape[0], origin.shape[0]
    dev = origin.device
    build.require(tab, "tri", torch.float32, (m, 9), dev)
    build.require(origin, "origin", torch.float32, (r, 3), dev)
    build.require(direction, "direction", torch.float32, (r, 3), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_tri_nearest_hit(
            tab.data_ptr(), m, origin.data_ptr(), direction.data_ptr(), r,
            t.data_ptr(), idx.data_ptr(), build.stream_of(origin))
    build.check("trt_tri_nearest_hit", err)
    tri_nearest_hit.launches += 1
    return Hit(t=t, idx=idx)


tri_nearest_hit.launches = 0
