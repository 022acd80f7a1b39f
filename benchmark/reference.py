"""The plain reference: a wavefront path tracer in plain PyTorch.

It renders what the program renders, the reference renderer's algorithm
(SIMD-Ray-Tracer ``main.cpp:348-495``): per (pixel, sample) a jittered
camera ray from the counter RNG, up to ``max_bounces`` bounces of
nearest-hit search, emission and attenuation, a diffuse/specular or
dielectric scatter, the sky on a miss. Every f32 operation is written in
the order the program's eager route writes it, so on the same device the
two agree bit for bit where the program computes the same way.

It imports nothing of the program and takes nothing the program made:
the scene arrays and the camera come from the harness (``scenes.py``),
and it derives the camera basis, the RNG streams and every search itself.
Its search is exact: a conservative cull by boxes over runs of ``CHUNK``
consecutive primitives (inflated, so no ray that hits a primitive misses
its box), then the exact test on the pairs that pass, the lowest id
winning a tie in t. ``cull=False`` tests every pair; the two agree bit for
bit (``tests/test_reference.py``).

``dtype`` is the precision of every floating-point value: float32 is the
configuration's, bfloat16 the control's (the nearest precision below).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MIX_PIXEL, MIX_SAMPLE = 0x9E3779B1, 0x85EBCA6B
MIX_BOUNCE, MIX_SLOT = 0x632BE59B, 0xC2B2AE35
EPS = float(np.float32(1e-4))
BIG = 1e30
DET_EPS = 1e-9
CHUNK = 32               # primitives a cull box covers
SLAB = 1 << 24           # elements of a search temporary


# ---- the counter RNG: u32 values carried in int64 ------------------------

def pcg_hash(x):
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def ray_base(seed: int, pixel, sample):
    h1 = pcg_hash(((pixel * MIX_PIXEL) & MASK32) ^ (int(seed) & MASK32))
    return pcg_hash((h1 + (sample * MIX_SAMPLE & MASK32)) & MASK32)


def uniform(base, bounce: int, slot: int, lo: float, hi: float, dtype):
    u = pcg_hash((base + ((bounce * MIX_BOUNCE) & MASK32)
                  + ((slot * MIX_SLOT) & MASK32)) & MASK32)
    scale = float(np.float32(hi - lo) * np.float32(1.0 / 4294967296.0))
    return u.to(dtype) * scale + float(np.float32(lo))


# ---- vector helpers --------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sqrt_rn(x):
    """The correctly rounded root in x's precision (taken in f64)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, sqrt_rn(torch.where(pos, x, 1.0)), 0.0)


def normalize_eps(v):
    """v/|v|, or 0 where |v|^2 <= 1e-4 (the reference's v3::Normalize)."""
    lsq = dot(v, v)[..., None]
    ok = lsq > EPS
    return torch.where(ok, v * (1.0 / sqrt_rn(torch.where(ok, lsq, 1.0))), 0.0)


# ---- scene -----------------------------------------------------------------

class Scene:
    """The harness's arrays as tensors of one precision on one device.
    ``leaves`` are the differentiable tensors by the program's leaf names
    (``requires_grad`` when ``grad``)."""

    def __init__(self, arrays: Dict[str, np.ndarray], static: dict, device,
                 dtype=torch.float32, grad: bool = False):
        self.leaves = {}
        for k, a in arrays.items():
            if k == "look_at":
                continue
            self.leaves[k] = torch.tensor(np.asarray(a), device=device).to(
                dtype).requires_grad_(grad)
        self.use_sky = bool(static["use_sky"])
        self.n = self.leaves["radius"].shape[0]
        self.has_tris = "tris.v0" in self.leaves
        self.dtype, self.device = dtype, torch.device(device)
        with torch.no_grad():
            self.sph_boxes = _sphere_boxes(self.leaves["center"],
                                           self.leaves["radius"])
            if self.has_tris:
                self.tri_boxes = _tri_boxes(self.leaves["tris.v0"],
                                            self.leaves["tris.e1"],
                                            self.leaves["tris.e2"])

    def sphere_table(self):
        g = self.leaves
        return torch.cat([g["center"], g["radius"][:, None], g["albedo"],
                          g["emissive"], g["specular"][:, None],
                          g["ior"][:, None]], dim=1)

    def tri_table(self):
        g = self.leaves
        return torch.cat([g["tris.v0"], g["tris.e1"], g["tris.e2"],
                          g["tris.albedo"], g["tris.emissive"],
                          g["tris.specular"][:, None], g["tris.ior"][:, None]],
                         dim=1)


def _inflate(lo, hi, dtype):
    """Boxes grown by a margin far past the rounding of the test in
    ``dtype``, so the cull never drops a pair the exact test accepts."""
    rel = max(1e-3, 16 * torch.finfo(dtype).eps)
    pad = rel * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    return torch.cat([lo - pad, hi + pad], dim=1)


def _sphere_boxes(center, radius):
    """[ceil(N/CHUNK), 6] f32 boxes over runs of CHUNK spheres; a run of
    padding gets an empty box."""
    n = center.shape[0]
    c = center.float().detach()
    r = radius.float().detach().abs()
    real = r > 0
    lo = torch.where(real[:, None], c - r[:, None], BIG)
    hi = torch.where(real[:, None], c + r[:, None], -BIG)
    k = -(-n // CHUNK)
    pad = k * CHUNK - n
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
    return _inflate(lo.view(k, CHUNK, 3).amin(1), hi.view(k, CHUNK, 3).amax(1),
                    center.dtype)


def _tri_boxes(v0, e1, e2):
    m, dtype = v0.shape[0], v0.dtype
    v0, e1, e2 = (x.float().detach() for x in (v0, e1, e2))
    real = (e1 != 0).any(1) | (e2 != 0).any(1)
    pts = torch.stack([v0, v0 + e1, v0 + e2], dim=1)
    lo = torch.where(real[:, None], pts.amin(1), BIG)
    hi = torch.where(real[:, None], pts.amax(1), -BIG)
    k = -(-m // CHUNK)
    pad = k * CHUNK - m
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=BIG)
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-BIG)
    return _inflate(lo.view(k, CHUNK, 3).amin(1), hi.view(k, CHUNK, 3).amax(1),
                    dtype)


def _box_pairs(boxes, o, d):
    """(ray, box) pairs whose ray meets the box ahead of its origin, in
    f32 with the box inflated: [K] ray ids, [K] box ids."""
    step = max(1, SLAB // (4 * boxes.shape[0]))
    rays, ids = [], []
    for k in range(0, o.shape[0], step):
        r, b = _box_slab(boxes, o[k:k + step], d[k:k + step])
        rays.append(r + k)
        ids.append(b)
    return torch.cat(rays), torch.cat(ids)


def _box_slab(boxes, o, d):
    o, d = o.float(), d.float()
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    zero = d[:, None, :] == 0
    dd = torch.where(zero, 1.0, d[:, None, :])
    t1 = (lo - o[:, None, :]) / dd
    t2 = (hi - o[:, None, :]) / dd
    inside = (o[:, None, :] >= lo) & (o[:, None, :] <= hi)
    tmin = torch.where(zero, torch.where(inside, -BIG, BIG),
                       torch.minimum(t1, t2))
    tmax = torch.where(zero, torch.where(inside, BIG, -BIG),
                       torch.maximum(t1, t2))
    enter = tmin.amax(2)
    leave = tmax.amin(2)
    ok = (leave >= enter) & (leave >= 0.0)
    pairs = ok.nonzero()
    return pairs[:, 0], pairs[:, 1]


# ---- search ----------------------------------------------------------------

def _sphere_t(c, r, o, d):
    """The projection-form hit test (main.cpp:401-429) -> t, BIG on a
    miss. Shapes broadcast."""
    mx, my, mz = c[..., 0] - o[..., 0], c[..., 1] - o[..., 1], c[..., 2] - o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    t_proj = mx * dx + my * dy + mz * dz
    px, py, pz = mx - dx * t_proj, my - dy * t_proj, mz - dz * t_proj
    dsq = px * px + py * py + pz * pz
    r2 = r * r
    x = safe_sqrt(r2 - dsq)
    t_near = t_proj - x
    t = torch.where(t_near < EPS, t_proj + x, t_near)
    return torch.where((dsq < r2) & (t > EPS), t, BIG)


def _tri_t(v0, e1, e2, o, d):
    """Moller-Trumbore with no backface culling -> t, BIG on a miss."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2[..., 2] - dz * e2[..., 1]
    py = dz * e2[..., 0] - dx * e2[..., 2]
    pz = dx * e2[..., 1] - dy * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    ok = torch.abs(det) > DET_EPS
    inv = torch.ones_like(det) / torch.where(ok, det, 1.0)
    tx, ty, tz = o[..., 0] - v0[..., 0], o[..., 1] - v0[..., 1], o[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return torch.where(valid, t, BIG)


def _nearest(test, prims, boxes, o, d, cull: bool):
    """The nearest primitive of each ray [R,3] -> ids [R] int64 (-1 on a
    miss); the lowest id wins a tie in t."""
    r, n = o.shape[0], prims[0].shape[0]
    dev = o.device
    best_t = torch.full((r,), BIG, dtype=o.dtype, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    if r == 0:
        return best_i
    if not cull:
        step = max(1, SLAB // n)
        for k in range(0, r, step):
            t = test(*(p[None] for p in prims), o[k:k + step, None],
                     d[k:k + step, None])
            tm, im = torch.min(t, dim=1)
            best_t[k:k + step] = tm
            best_i[k:k + step] = torch.where(tm < BIG, im, -1)
        return best_i
    ray, box = _box_pairs(boxes, o, d)
    if ray.numel() == 0:
        return best_i
    lane = torch.arange(CHUNK, device=dev)
    step = max(1, SLAB // CHUNK)
    rays, ids, ts = [], [], []
    for k in range(0, ray.numel(), step):
        rk = ray[k:k + step]
        ik = (box[k:k + step, None] * CHUNK + lane[None]).clamp_(max=n - 1)
        t = test(*(p[ik] for p in prims), o[rk][:, None], d[rk][:, None])
        keep = t < BIG
        rays.append(rk[:, None].expand_as(ik)[keep])
        ids.append(ik[keep])
        ts.append(t[keep])
    ray_h, id_h, t_h = torch.cat(rays), torch.cat(ids), torch.cat(ts)
    best_t.scatter_reduce_(0, ray_h, t_h, "amin")
    win = t_h == best_t[ray_h]
    cand = torch.full((r,), n, dtype=torch.int64, device=dev)
    cand.scatter_reduce_(0, ray_h[win], id_h[win], "amin")
    return torch.where(cand < n, cand, -1)


@torch.no_grad()
def search(sc: Scene, o, d, cull: bool = True):
    """-> (sphere winner [R], triangle winner [R] or None), -1 on a miss."""
    g = sc.leaves
    s = _nearest(_sphere_t, (g["center"], g["radius"]), sc.sph_boxes, o, d,
                 cull)
    if not sc.has_tris:
        return s, None
    t = _nearest(_tri_t, (g["tris.v0"], g["tris.e1"], g["tris.e2"]),
                 sc.tri_boxes, o, d, cull)
    return s, t


# ---- payload and shading -----------------------------------------------------

def _sphere_payload(table, o, d, idx):
    g = table.index_select(0, idx.clamp(min=0))
    c, r = g[:, 0:3], g[:, 3]
    m = c - o
    t_proj = dot(m, d)
    p = m - d * t_proj[..., None]
    dsq = dot(p, p)
    x = safe_sqrt(r * r - dsq)
    t_near = t_proj - x
    inside = t_near < EPS
    t = torch.where(inside, t_proj + x, t_near)
    point = d * t[..., None]
    return dict(hit=idx >= 0, t=t, next_origin=o + point,
                normal_raw=point - m, inside=inside, albedo=g[:, 4:7],
                emissive=g[:, 7:10], specular=g[:, 10], ior=g[:, 11])


def _tri_payload(table, o, d, idx):
    g = table.index_select(0, idx.clamp(min=0))
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv = torch.ones_like(det) / torch.where(torch.abs(det) > DET_EPS, det, 1.0)
    t = dot(e2, cross(o - v0, e1)) * inv
    normal_raw = cross(e1, e2)
    return dict(hit=idx >= 0, t=t, next_origin=o + d * t[..., None],
                normal_raw=normal_raw, inside=dot(d, normal_raw) > 0.0,
                albedo=g[:, 9:12], emissive=g[:, 12:15], specular=g[:, 15],
                ior=g[:, 16])


def _merge(sp, tp):
    """A triangle wins only with a strictly smaller t (a sphere, the lower
    id, wins a tie)."""
    st = torch.where(sp["hit"], sp["t"], BIG)
    tt = torch.where(tp["hit"], tp["t"], BIG)
    tri = tt < st
    out = {k: torch.where(tri[..., None] if sp[k].dim() > 1 else tri,
                          tp[k], sp[k]) for k in sp}
    out["hit"] = sp["hit"] | tp["hit"]
    return out


def sky_color(d):
    a = (d[..., 1] + 1.0) * 0.5
    white = torch.ones(3, dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def scatter(d, normal_raw, inside, specular, ior, rand3, rand_reflect):
    """The new direction after a hit (main.cpp:446-481)."""
    normal = normalize_eps(normal_raw)
    pure = d - 2.0 * dot(d, normal)[..., None] * normal
    n2 = torch.where(inside[..., None], -normal, normal)
    spec = specular[..., None]
    d_diffuse = normalize_eps((1.0 - spec) * (n2 + normalize_eps(rand3))
                              + spec * pure)
    ior_safe = torch.where(ior == 0.0, 1.0, ior)
    ri = torch.where(inside, ior_safe, 1.0 / ior_safe)
    cos_theta = torch.clamp_max(dot(-d, n2), 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cant_refract = ri * sin_theta > 1.0
    perp = ri[..., None] * (d + cos_theta[..., None] * n2)
    par = -safe_sqrt(torch.abs(1.0 - dot(perp, perp)))[..., None] * n2
    refracted = normalize_eps(perp + par)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    r1 = 1.0 - cos_theta
    r1 = r1 * r1 * r1 * r1 * r1
    reflect = (cant_refract | (r0 + (1.0 - r0) * r1 > rand_reflect)) & ~inside
    d_dielectric = torch.where(reflect[..., None], pure, refracted)
    return torch.where((ior == 0.0)[..., None], d_diffuse, d_dielectric)


# ---- camera ------------------------------------------------------------------

def _unit(v):
    return v / torch.sqrt(torch.sum(v * v))


def basis(position, look_at):
    """(cam_x, cam_y, cam_z, film_center), main.cpp:811-814."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=position.dtype,
                      device=position.device)
    z = _unit(position - look_at)
    x = _unit(torch.linalg.cross(up, z))
    y = _unit(torch.linalg.cross(z, x))
    return x, y, z, position - z


def camera_rays(position, look_at, width: int, height: int, pixel, sample,
                seed: int):
    """Jittered primary rays of lanes (pixel [L], sample [L] or int) ->
    (origins [L,3], directions [L,3], stream base [L])."""
    dt = position.dtype
    base = ray_base(seed, pixel, sample)
    ax = (pixel % width).to(dt)
    ay = torch.div(pixel, width, rounding_mode="floor").to(dt)
    cam_x, cam_y, _, film_center = basis(position, look_at)
    jx = uniform(base, 0, 4, -0.5, 0.5, dt)
    jy = uniform(base, 0, 5, -0.5, 0.5, dt)
    w = torch.tensor(float(width), dtype=dt, device=pixel.device)
    h = torch.tensor(float(height), dtype=dt, device=pixel.device)
    film_x = -1.0 + torch.div((ax + jx) * 2.0, w)
    film_y = -1.0 + torch.div((ay + jy) * 2.0, h)
    film_w = film_h = np.float32(1.0)
    if width > height:
        film_h = np.float32(float(height) / float(width))
    else:
        film_w = np.float32(float(width) / float(height))
    fx = film_x * float(film_w) * 0.5
    fy = film_y * float(film_h) * 0.5
    film_p = (film_center + fx[..., None] * cam_x) + fy[..., None] * cam_y
    d = normalize_eps(film_p - position)
    return position.expand_as(d).contiguous(), d, base


# ---- the trace ---------------------------------------------------------------

def trace(sc: Scene, position, look_at, *, width: int, height: int, pixel,
          sample, seed: int, max_bounces: int,
          hits: Optional[List] = None, cull: bool = True,
          keep: bool = False):
    """Trace lanes (pixel [L], sample [L] or int) to completion -> (colour
    [L,3], rays cast [L] int64, the searches' winners by bounce if
    ``keep``). With ``hits`` (a previous call's winners) the searches are
    replayed, not run: the backward pass re-traces from them under
    autograd."""
    o, d, base = camera_rays(position, look_at, width, height, pixel, sample,
                             seed)
    n = o.shape[0]
    dt, dev = o.dtype, o.device
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    color = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    sph_tab = sc.sphere_table()
    tri_tab = sc.tri_table() if sc.has_tris else None
    record = []
    for b in range(max_bounces):
        if not bool(alive.any()):
            break
        rays = rays + alive
        if hits is None:
            lanes = alive.nonzero()[:, 0]
            s_l, t_l = search(sc, o.detach()[lanes], d.detach()[lanes], cull)
            s_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
            s_idx[lanes] = s_l
            t_idx = None
            if t_l is not None:
                t_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
                t_idx[lanes] = t_l
            if keep:
                record.append((s_idx, t_idx))
        else:
            s_idx, t_idx = hits[b]
        p = _sphere_payload(sph_tab, o, d, s_idx)
        if t_idx is not None:
            p = _merge(p, _tri_payload(tri_tab, o, d, t_idx))
        if sc.use_sky:
            sky = (alive & ~p["hit"])[..., None]
            color = color + torch.where(sky, sky_color(d) * atten, 0.0)
        live_hit = alive & p["hit"]
        lh = live_hit[..., None]
        color = color + torch.where(lh, p["emissive"] * atten, 0.0)
        atten = torch.where(lh, atten * p["albedo"], atten)
        rand3 = torch.stack([uniform(base, b, s, -1.0, 1.0, dt)
                             for s in range(3)], dim=-1)
        rand_reflect = uniform(base, b, 3, 0.0, 1.0, dt)
        new_d = scatter(d, p["normal_raw"], p["inside"], p["specular"],
                        p["ior"], rand3, rand_reflect)
        d = torch.where(lh, new_d, d)
        o = torch.where(lh, p["next_origin"], o)
        alive = live_hit
    return color, rays, record


def render(sc: Scene, position, look_at, *, width: int, height: int,
           pixels, spp: int, sample_start: int, seed: int, max_bounces: int,
           lanes: int = 1 << 21, cotangent=None, cull: bool = True):
    """The spp-sample colour sums of a pixel set [P] -> (colour_sum [P,3]
    summed in sample order, rays cast int). Samples run in groups of whole
    samples of at most ``lanes`` lanes. ``cotangent``: a function of
    colour_sum giving the loss's gradient with respect to it [P,3]; the
    samples are then re-traced under autograd from the recorded winners
    and the gradient added to ``.grad`` of every leaf that requires it
    (the scene's and the camera's)."""
    n_pix = pixels.shape[0]
    per = max(1, min(spp, lanes // max(n_pix, 1)))
    dev = pixels.device
    total = torch.zeros((n_pix, 3), dtype=sc.dtype, device=dev)
    rays = 0
    groups = []
    with torch.no_grad():
        for s0 in range(sample_start, sample_start + spp, per):
            k = min(per, sample_start + spp - s0)
            sample = (s0 + torch.arange(k, device=dev)).repeat_interleave(n_pix)
            pix = pixels.repeat(k)
            c, rc, rec = trace(sc, position.detach(), look_at.detach(),
                               width=width, height=height, pixel=pix,
                               sample=sample, seed=seed,
                               max_bounces=max_bounces, cull=cull,
                               keep=cotangent is not None)
            for j in range(k):
                total = total + c[j * n_pix:(j + 1) * n_pix]
            rays += int(rc.sum())
            if cotangent is not None:
                groups.append((pix, sample, rec, k))
    if cotangent is not None:
        cot = cotangent(total)
        for pix, sample, rec, k in groups:
            c, _, _ = trace(sc, position, look_at, width=width, height=height,
                            pixel=pix, sample=sample, seed=seed,
                            max_bounces=max_bounces, hits=rec, cull=cull)
            torch.sum(c * cot.repeat(k, 1)).backward()
    return total, rays
