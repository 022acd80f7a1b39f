"""CPU oracle: a NumPy re-execution of the reference scalar tracer.

The reference keeps a scalar kernel (RenderTileScalar, reference
main.cpp:497-640) as the live A/B correctness oracle for its SIMD kernel
(the EnableSIMD toggle, main.cpp:853). This module plays the same role for
the port's kernels: an independent, branchy, per-pixel re-execution of
the same algorithm in float32 NumPy, with the same counter RNG
(``oracle/_rng.py``, bit-equal to ``core/rng.py``), so the card's images
must match it allclose. It is the port's copy of
``tpu_ray/oracle/cpu_oracle.py``, op for op.

It takes the port's ``Scene`` and camera on any device and copies them to
the host: a CPU re-execution by definition. Its structure is deliberately
unlike the card's: a Python loop over pixels with real ``if``/``break``,
spheres and triangles vectorized per ray. Slow; use small images.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_ray_torch.core.camera import film_extent
from tpu_ray_torch.core.scene import F32_EPS, F32_MAX, Scene
from tpu_ray_torch.oracle import _rng as rng

f32 = np.float32


def host(x) -> np.ndarray:
    """A tensor (any device) or array-like -> a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, f32)


def _normalize_eps(v: np.ndarray) -> np.ndarray:
    # reference v3::Normalize (x64_math.h:234-245)
    lsq = f32(v @ v)
    if not lsq > F32_EPS:
        return np.zeros(3, f32)
    return (v / f32(np.sqrt(lsq))).astype(f32)


def _schlick(cos_theta: f32, ri: f32) -> f32:
    # reference Reflectance (main.cpp:292-300)
    r0 = f32((1.0 - ri) / (1.0 + ri))
    r0 = f32(r0 * r0)
    r1 = f32(1.0 - cos_theta)
    r1 = f32(r1 * r1 * r1 * r1 * r1)
    return f32(r0 + (1.0 - r0) * r1)


class CpuOracle:
    def __init__(self, scene: Scene):
        self.center = host(scene.center)
        self.radius = host(scene.radius)
        self.r2 = self.radius * self.radius
        self.albedo = host(scene.albedo)
        self.emissive = host(scene.emissive)
        self.specular = host(scene.specular)
        self.ior = host(scene.ior)
        self.use_sky = scene.use_sky
        self.tris = scene.tris
        if scene.tris is not None:
            t = scene.tris
            self.tv0 = host(t.v0)
            self.te1 = host(t.e1)
            self.te2 = host(t.e2)
            self.t_albedo = host(t.albedo)
            self.t_emissive = host(t.emissive)
            self.t_specular = host(t.specular)
            self.t_ior = host(t.ior)
            # geometric normals (area-scaled), ops/intersect_tri.tri_payload
            self.t_n = np.cross(self.te1, self.te2).astype(f32)

    # -- nearest hit: vectorized over spheres, reference main.cpp:547-579 --
    def _nearest(self, o: np.ndarray, d: np.ndarray):
        m = self.center - o                       # [N,3]
        t_proj = m @ d                            # [N]
        p = m - t_proj[:, None] * d
        dsq = np.einsum("ij,ij->i", p, p)
        hit = dsq < self.r2
        x = np.sqrt(np.maximum(self.r2 - dsq, f32(0.0)))
        t_near = t_proj - x
        inside = t_near < F32_EPS
        t = np.where(inside, t_proj + x, t_near)
        valid = hit & (t > F32_EPS)
        tv = np.where(valid, t, F32_MAX).astype(f32)
        i = int(np.argmin(tv))
        return tv[i], i, bool(inside[i])

    # -- Möller-Trumbore over the soup (ops/intersect_tri semantics) --
    def _nearest_tri(self, o: np.ndarray, d: np.ndarray):
        pvec = np.cross(np.broadcast_to(d, self.te2.shape), self.te2)
        det = np.einsum("ij,ij->i", self.te1, pvec)
        ok = np.abs(det) > f32(1e-9)
        inv = f32(1.0) / np.where(ok, det, f32(1.0))
        tvec = (o - self.tv0).astype(f32)
        u = np.einsum("ij,ij->i", tvec, pvec) * inv
        qvec = np.cross(tvec, self.te1)
        v = (qvec @ d) * inv
        t = np.einsum("ij,ij->i", self.te2, qvec) * inv
        valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > F32_EPS)
        tvals = np.where(valid, t, F32_MAX).astype(f32)
        i = int(np.argmin(tvals))
        # backface hit counts as "inside" (reference main.cpp:456-458 rule)
        return tvals[i], i, bool(d @ self.t_n[i] > 0.0)

    def _trace_pixel(self, o, d, base, max_bounces: int):
        atten = np.ones(3, f32)
        color = np.zeros(3, f32)
        rays = 0
        for b in range(max_bounces):
            rays += 1
            tmin, i, inside = self._nearest(o, d)
            is_tri = False
            if self.tris is not None:
                t_t, j, ins_t = self._nearest_tri(o, d)
                if t_t < tmin:                # sphere wins exact ties
                    tmin, i, inside, is_tri = t_t, j, ins_t, True
            if tmin >= F32_MAX:  # miss (reference main.cpp:581-588)
                if self.use_sky:
                    a = f32((d[1] + 1.0) * 0.5)
                    sky = ((1.0 - a) * np.ones(3, f32)
                           + a * np.array([0.5, 0.7, 1.0], f32)).astype(f32)
                    color = color + sky * atten
                break

            point = d * tmin                      # hit point relative to o
            next_o = (o + point).astype(f32)
            if is_tri:
                normal_raw = self.t_n[i]
                emissive, albedo = self.t_emissive[i], self.t_albedo[i]
                spec, ior = self.t_specular[i], self.t_ior[i]
            else:
                c = self.center[i]
                normal_raw = (point - (c - o)).astype(f32)
                emissive, albedo = self.emissive[i], self.albedo[i]
                spec, ior = self.specular[i], self.ior[i]

            color = color + emissive * atten
            atten = (atten * albedo).astype(f32)
            o = next_o
            normal = _normalize_eps(normal_raw)
            pure = (d - f32(2.0) * f32(d @ normal) * normal).astype(f32)
            n2 = -normal if inside else normal

            if ior == 0.0:
                # diffuse/specular mix (reference main.cpp:605-609)
                rv = np.array([rng.draw_uniform(base, b, s, -1.0, 1.0)
                               for s in range(3)], f32)
                rb = n2 + _normalize_eps(rv)
                d = _normalize_eps(
                    ((1.0 - spec) * rb + spec * pure).astype(f32))
            else:
                # dielectric (reference main.cpp:610-626)
                ri = ior if inside else f32(1.0 / ior)
                cos_t = f32(min(f32(-d @ n2), f32(1.0)))
                sin_t = f32(np.sqrt(max(f32(1.0 - cos_t * cos_t), f32(0.0))))
                cant = ri * sin_t > 1.0
                perp = (ri * (d + cos_t * n2)).astype(f32)
                par = (-f32(np.sqrt(abs(f32(1.0 - perp @ perp))))
                       * n2).astype(f32)
                refr = _normalize_eps((perp + par).astype(f32))
                rr = rng.draw_uniform(base, b, 3, 0.0, 1.0)
                if (cant or _schlick(cos_t, ri) > rr) and not inside:
                    d = pure
                else:
                    d = refr
        return color, rays

    def render_pass(self, camera_position, look_at, width: int, height: int,
                    spp: int = 1, sample_start: int = 0, seed: int = 0,
                    max_bounces: int = 5):
        """-> (image_sum [H,W,3] f32 linear radiance summed over spp, rays).

        The semantics of ``models.path_tracer.render_pass``; the camera's
        position and target may be tensors on any device or arrays.
        """
        pos = host(camera_position)
        tgt = host(look_at)
        up = np.array([0.0, 1.0, 0.0], f32)
        z = pos - tgt
        z = (z / f32(np.sqrt(z @ z))).astype(f32)
        x = np.cross(up, z).astype(f32)
        x = (x / f32(np.sqrt(x @ x))).astype(f32)
        y = np.cross(z, x).astype(f32)
        y = (y / f32(np.sqrt(y @ y))).astype(f32)
        film_center = (pos - z).astype(f32)
        film_w, film_h = film_extent(width, height)

        img = np.zeros((height, width, 3), f32)
        total_rays = 0
        for s in range(sample_start, sample_start + spp):
            for pix in range(width * height):
                base = rng.ray_base(seed, np.asarray(pix, np.uint32),
                                    np.asarray(s, np.uint32))
                jx = rng.draw_uniform(base, 0, 4, -0.5, 0.5)
                jy = rng.draw_uniform(base, 0, 5, -0.5, 0.5)
                px, py = pix % width, pix // width
                film_x = f32(-1.0 + ((px + jx) * f32(2.0)) / f32(width))
                film_y = f32(-1.0 + ((py + jy) * f32(2.0)) / f32(height))
                film_p = (film_center
                          + (film_x * film_w * f32(0.5)) * x
                          + (film_y * film_h * f32(0.5)) * y).astype(f32)
                d = _normalize_eps((film_p - pos).astype(f32))
                color, rays = self._trace_pixel(pos.copy(), d, base,
                                                max_bounces)
                img[py, px] += color
                total_rays += rays
        return img, total_rays
