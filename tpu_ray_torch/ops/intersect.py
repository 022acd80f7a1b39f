"""Ray-sphere intersection: nearest-hit search + hit payload.

Port of ``tpu_ray/ops/intersect.py``. The O(R*N) search returns the nearest
sphere index per ray (and t, for the miss test); the payload is recomputed
per ray from the winning sphere in ``hit_payload``. The geometric test is
the projection form of the reference SIMD kernel (main.cpp:401-429):
project the centre onto the ray, compare the squared distance with r^2,
take the near root t_proj - x, the far root when the near one is behind the
origin, and reject t <= 1e-4. Radius-0 padding never passes ``dsq < r^2``.
The JAX package's matmul-transpose gather is a TPU workaround; the port
indexes the table directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_ray_torch.core.scene import F32_EPS, F32_MAX, Scene
from tpu_ray_torch.ops.vec import dot, safe_sqrt

_EPS = float(F32_EPS)
_MAX = float(F32_MAX)


class Hit(NamedTuple):
    t: torch.Tensor    # [R] f32, F32_MAX on miss
    idx: torch.Tensor  # [R] i32 winning sphere (0 on a miss; check t)


def nearest_hit(center, radius, origin, direction) -> Hit:
    """Brute-force nearest hit over all spheres; the lowest index wins a
    tie in t. center [N,3], radius [N], origin/direction [R,3] -> Hit."""
    cx, cy, cz = center[None, :, 0], center[None, :, 1], center[None, :, 2]
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]

    mx, my, mz = cx - ox, cy - oy, cz - oz
    t_proj = mx * dx + my * dy + mz * dz
    px, py, pz = mx - dx * t_proj, my - dy * t_proj, mz - dz * t_proj
    dsq = px * px + py * py + pz * pz
    r2 = (radius * radius)[None, :]
    hit = dsq < r2
    x = safe_sqrt(r2 - dsq)
    t_near = t_proj - x
    t = torch.where(t_near < _EPS, t_proj + x, t_near)
    tvals = torch.where(hit & (t > _EPS), t, _MAX)
    tmin, idx = torch.min(tvals, dim=1)
    return Hit(t=tmin, idx=idx.to(torch.int32))


class Payload(NamedTuple):
    hit: torch.Tensor          # [R] bool, False = miss
    idx: torch.Tensor          # [R] i32 winning sphere index
    t: torch.Tensor            # [R] f32 recomputed
    next_origin: torch.Tensor  # [R,3]
    normal_raw: torch.Tensor   # [R,3] unnormalized (hit point - center)
    inside: torch.Tensor       # [R] bool, ray started inside the sphere
    albedo: torch.Tensor       # [R,3]
    emissive: torch.Tensor     # [R,3]
    specular: torch.Tensor     # [R]
    ior: torch.Tensor          # [R]


def payload_tables(scene: Scene):
    """One [N,12] gather table: center|radius|albedo|emissive|specular|ior."""
    return torch.cat([scene.center, scene.radius[:, None], scene.albedo,
                      scene.emissive, scene.specular[:, None],
                      scene.ior[:, None]], dim=1)


def hit_payload(scene: Scene, origin, direction, hit: Hit,
                tables=None) -> Payload:
    """Recompute the hit attributes from the winning sphere (reference
    main.cpp:413-429 roots and inside flag, 443-455 payload)."""
    table = payload_tables(scene) if tables is None else tables
    g = table[hit.idx.long()]      # [R,12]
    c = g[:, 0:3]
    r = g[:, 3]

    m = c - origin
    t_proj = dot(m, direction)
    p = m - direction * t_proj[..., None]
    dsq = dot(p, p)
    x = safe_sqrt(r * r - dsq)
    t_near = t_proj - x
    inside = t_near < _EPS
    t = torch.where(inside, t_proj + x, t_near)

    point = direction * t[..., None]
    return Payload(
        hit=hit.t < _MAX,
        idx=hit.idx,
        t=t,
        next_origin=origin + point,
        normal_raw=point - m,
        inside=inside,
        albedo=g[:, 4:7],
        emissive=g[:, 7:10],
        specular=g[:, 10],
        ior=g[:, 11],
    )
