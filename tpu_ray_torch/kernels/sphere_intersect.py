"""K1: nearest sphere hit per ray, the CUDA kernel ``csrc/sphere_intersect.cu``.

Replaces ``tpu_ray/kernels/sphere_intersect.py::nearest_hit_pallas``. Its
plain version is ``ops/intersect.nearest_hit``: the wrapper takes it for
CPU tensors only; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.kernels import build
from tpu_ray_torch.ops.intersect import Hit, nearest_hit as nearest_hit_plain

__all__ = ["sphere_nearest_hit", "nearest_hit_plain"]


def sphere_nearest_hit(center, radius, origin, direction) -> Hit:
    """center [N,3], radius [N], origin/direction [R,3] f32 -> Hit(t [R] f32,
    idx [R] i32): the exact nearest hit, lowest index on ties. Neither
    output carries autograd history (the search is a discrete choice)."""
    if not origin.is_cuda:
        return nearest_hit_plain(center, radius, origin, direction)
    n, r = center.shape[0], origin.shape[0]
    dev = origin.device
    build.require(center, "center", torch.float32, (n, 3), dev)
    build.require(radius, "radius", torch.float32, (n,), dev)
    build.require(origin, "origin", torch.float32, (r, 3), dev)
    build.require(direction, "direction", torch.float32, (r, 3), dev)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_sphere_nearest_hit(
            center.data_ptr(), radius.data_ptr(), n, origin.data_ptr(),
            direction.data_ptr(), r, t.data_ptr(), idx.data_ptr(),
            build.stream_of(origin))
    build.check("trt_sphere_nearest_hit", err)
    sphere_nearest_hit.launches += 1
    return Hit(t=t, idx=idx)


sphere_nearest_hit.launches = 0
