"""Ray-triangle intersection: Möller-Trumbore nearest hit + hit payload.

Port of ``tpu_ray/ops/intersect_tri.py``. As for spheres, the O(R*M)
search returns only the winner (t, index) and carries no autograd history;
the differentiable attributes are recomputed O(R) from the winning
triangle in ``tri_payload``, so gradients reach v0/e1/e2 and the materials
without going through the search. The test is the standard Möller-Trumbore
with no backface culling (|det| > 1e-9); degenerate padding triangles have
det = 0 and never hit. The search's f32 op sequence is the one
``csrc/common.cuh`` ``trt_fold_tris`` repeats, so the kernels built on it
agree with this plain version bit for bit.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.core.scene import F32_EPS, F32_MAX
from tpu_ray_torch.core.trimesh import Triangles
from tpu_ray_torch.ops.intersect import Hit, Payload, gather_rows

_EPS = float(F32_EPS)
_MAX = float(F32_MAX)
_DET_EPS = 1e-9
# rays per slab of the brute-force search: a slab's [rays, M] temporaries
# stay near 2^23 elements whatever M is
_SLAB_ELEMS = 1 << 23


def _recip(x):
    """1/x, correctly rounded on every device (a true division; PyTorch's
    CPU reciprocal is not)."""
    return torch.ones_like(x) / x


def cross(a, b):
    """a x b over trailing dim-3 axes, in numpy's (and jnp's) op order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def tri_search_table(tris: Triangles):
    """[M,9] f32 v0|e1|e2, contiguous and without autograd history: the
    search's input (the kernels read it as is)."""
    return torch.cat([tris.v0, tris.e1, tris.e2], dim=1).detach().contiguous()


def _mt_slab(tab, origin, direction):
    """Möller-Trumbore for a slab of rays [r,3] against the triangles of
    tab, [1,M,9] (the same M for every ray) or [r,M,9] (each ray its own)
    -> t [r,M] with F32_MAX where there is no hit."""
    v0x, v0y, v0z = tab[..., 0], tab[..., 1], tab[..., 2]
    e1x, e1y, e1z = tab[..., 3], tab[..., 4], tab[..., 5]
    e2x, e2y, e2z = tab[..., 6], tab[..., 7], tab[..., 8]
    ox, oy, oz = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    dx, dy, dz = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > _DET_EPS
    inv = _recip(torch.where(ok, det, 1.0))
    # tvec = o - v0
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _EPS)
    return torch.where(valid, t, _MAX)


@torch.no_grad()
def nearest_hit_tri(tab, origin, direction, tiles=None) -> Hit:
    """Brute-force nearest triangle hit (JAX ``nearest_hit_tri_jnp``).
    tab: the triangles' ``tri_search_table`` [M,9]; origin/direction
    [R,3] -> Hit(t [R] f32, F32_MAX on a miss; idx [R] i32, the lowest
    index on ties, 0 on a miss). tiles: optional [R,T] bool, False where
    the search skips one of the T equal tiles of consecutive triangles
    (a tile the per-sample route's reachable-tile list leaves out). Runs
    in slabs of rays, so its [R,M] temporaries stay bounded."""
    r, m = origin.shape[0], tab.shape[0]
    step = max(1, _SLAB_ELEMS // max(m, 1))
    ts, idxs = [], []
    for k in range(0, r, step):
        t = _mt_slab(tab[None], origin[k:k + step], direction[k:k + step])
        if tiles is not None:
            keep = tiles[k:k + step].repeat_interleave(
                m // tiles.shape[1], dim=1)
            t = torch.where(keep, t, _MAX)
        t, idx = torch.min(t, dim=1)
        ts.append(t)
        idxs.append(idx.to(torch.int32))
    if not ts:
        return Hit(t=origin.new_zeros(0),
                   idx=torch.zeros(0, dtype=torch.int32,
                                   device=origin.device))
    return Hit(t=torch.cat(ts), idx=torch.cat(idxs))


def tri_payload_tables(tris: Triangles):
    """One [M,17] gather table: v0|e1|e2|albedo|emissive|specular|ior."""
    return torch.cat([tris.v0, tris.e1, tris.e2, tris.albedo, tris.emissive,
                      tris.specular[:, None], tris.ior[:, None]], dim=1)


def tri_payload(tris: Triangles, origin, direction, hit: Hit,
                tables=None) -> Payload:
    """Differentiable payload recompute from the winning triangle (the
    Möller-Trumbore t, JAX ``tri_payload``). A ray that meets the backface
    (d . n > 0, n = e1 x e2) counts as inside, for the shading's normal
    flip and dielectric rules."""
    table = tri_payload_tables(tris) if tables is None else tables
    g = gather_rows(table, hit.idx)
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    pvec = cross(direction, e2)
    det = _dot(e1, pvec)
    inv = _recip(torch.where(torch.abs(det) > _DET_EPS, det, 1.0))
    qvec = cross(origin - v0, e1)
    t = _dot(e2, qvec) * inv
    normal_raw = cross(e1, e2)
    return Payload(
        hit=hit.t < _MAX,
        idx=hit.idx,
        t=t,
        next_origin=origin + direction * t[..., None],
        normal_raw=normal_raw,
        inside=_dot(direction, normal_raw) > 0.0,
        albedo=g[:, 9:12],
        emissive=g[:, 12:15],
        specular=g[:, 15],
        ior=g[:, 16],
    )


def merge_payloads(sphere_p: Payload, tri_p: Payload,
                   n_spheres: int) -> Payload:
    """The per-ray winner of the sphere and triangle payloads. A triangle
    wins only with a strictly smaller t, so a sphere wins a tie (the lower
    id). Triangle ids are offset by n_spheres into one primitive id
    space."""
    st = torch.where(sphere_p.hit, sphere_p.t, _MAX)
    tt = torch.where(tri_p.hit, tri_p.t, _MAX)
    tri_wins = tt < st

    def sel(a, b):
        w = tri_wins[..., None] if a.dim() > 1 else tri_wins
        return torch.where(w, b, a)

    merged = Payload(*[sel(a, b) for a, b in zip(sphere_p, tri_p)])
    return merged._replace(
        hit=sphere_p.hit | tri_p.hit,
        idx=torch.where(tri_wins, tri_p.idx + n_spheres, sphere_p.idx))
