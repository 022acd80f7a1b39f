"""The bounce kernels of the per-sample fused route, their plain versions,
and the shading chain they share with the regen route.

Port of ``tpu_ray/kernels/bounce_step.py`` (the per-sample route takes
sphere scenes and the triangle scenes within ``resident_tables_fit``;
past it ``models/path_tracer.render_pixels`` takes the probe route):

- ``shade_plain`` / ``shade_vjp_plain`` (JAX ``_shade`` / ``_shade_vjp``):
  one bounce's smooth state update given the winner, and its hand
  transpose, with the triangle branch (the plane form) where the scene has
  triangles. ``csrc/shade.cuh`` repeats their f32 op sequence, so every
  kernel built on them agrees with its plain version bit for bit.
- ``prim_table``: the [P,12] winner table over the one primitive id space
  (spheres, then triangles); ``permute_scene``: the Morton permutation of
  spheres and triangles that both fused routes apply;
  ``resident_tables_fit``: the JAX package's residency rule, which both
  packages route triangle scenes by.
- K4 ``bounce_fwd`` (``_fwd_kernel``): search + shading of one bounce,
  the spheres culled in the kernel by the Morton sphere tiles of
  ``regen.sphere_tiles`` (the route's search), by a (ray block x sphere
  tile) mask, or not at all; its triangle mode (``tri=``, JAX's
  ``tri_tab``) then sweeps every triangle;
  K8 ``bounce_fwd_list`` (``_fwd_list_kernel``): the same for a triangle
  scene, the triangles searched over the tiles that a per-block slab test
  (``tri_block_lists``) keeps, front to back; K5 ``bounce_replay``
  (``_replay_kernel``):
  the shading from a saved winner; K6 ``bounce_bwd`` (``_bwd_kernel``):
  the bounce's transpose. K5 and K6 take ``n_sph``, the sphere rows of
  the table, on a triangle scene (a winner id at or past it is a
  triangle). CUDA in ``csrc/bounce.cu``; each wrapper takes its plain
  version (``*_plain``) for CPU tensors only.
- The host side of the route: the Morton permutation of the spheres and
  triangles, the conservative cull masks and triangle-tile boxes,
  ``trace_rays_fused`` (forward only) and ``make_fused_sample``, the
  differentiable sample (a ``torch.autograd.Function``, the JAX custom
  VJP).

The shading functions work on rows: a state ``st`` [16,R] (rows 0-2
origin, 3-5 direction, 6-8 attenuation, 9-11 colour, 12 alive, 13 rng base
bits, 14-15 passed through: the regen route's sample and bounce, unused
here) and the gathered winner ``winner`` [>=12,R] (rows 0-2 centre, 3
radius, 4-6 albedo, 7-9 emissive, 10 specular, 11 ior: the columns of
``scene_table``; a triangle's row holds n = e1 x e2 in the centre slots
and k = n . v0 in the radius slot, ``prim_table``). For spheres
``shade_plain`` repeats the f32 op sequence of ``ops/intersect.hit_payload``
+ ``ops/shade.scatter_direction``, so the routes built on it are bit-equal
to the bounce-loop render; for triangles it recomputes t in the plane form
t = (k - n . o) / (n . d), as the JAX kernels do, where the bounce loop
takes the Möller-Trumbore t of ``ops/intersect_tri.tri_payload``.
``shade_vjp_plain`` recomputes those primals in the same op order and
pushes a cotangent back through them. Normalisation is the port's
``1 / sqrt`` (``ops/vec.normalize_eps``), not the JAX package's rsqrt.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.core.scene import F32_EPS, F32_MAX, Scene
from tpu_ray_torch.core.trimesh import Triangles
from tpu_ray_torch.kernels import build
from tpu_ray_torch.ops.intersect import nearest_hit
from tpu_ray_torch.ops.intersect import payload_tables as scene_table
from tpu_ray_torch.ops.intersect_tri import (cross, nearest_hit_tri,
                                             tri_search_table)
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.ops.vec import safe_sqrt, sqrt_f32

if TYPE_CHECKING:
    from tpu_ray_torch.kernels.regen import SphereTiles

__all__ = ["shade_plain", "shade_vjp_plain", "nrm3_fwd", "nrm3_bwd",
           "scene_table", "prim_table", "BLOCK_R", "BLOCK_N", "morton_perm",
           "permute_spheres", "tri_morton_perm", "permute_tris",
           "permute_scene", "resident_tables_fit", "tile_bounds", "ray_block_bounds",
           "nearest_prim",
           "cull_mask", "bounce_cull_mask", "octant_occupancy",
           "bounce_cull_mask_octant", "TRI_BLOCK_M", "tri_tile_bounds",
           "tri_tile_boxes", "tab_tile_boxes", "tri_block_lists",
           "init_state", "bounce_fwd",
           "bounce_fwd_plain", "bounce_fwd_list", "bounce_fwd_list_plain",
           "bounce_replay", "bounce_replay_plain",
           "bounce_bwd", "bounce_bwd_plain", "bounce_bwd_lanes_plain",
           "table_sum_fixed_order", "MERGE_STATS", "FusedTables",
           "fused_tables",
           "origin_bound",
           "trace_rays_fused", "FusedSample", "make_fused_sample"]

_EPS = float(F32_EPS)
_MAX = float(F32_MAX)
# lanes of a K4/K5/K6 thread block, and so the ray block of the cull mask
# (csrc/bounce.cu TRT_BOUNCE_THREADS); the JAX package's is 1024
BLOCK_R = 256
# spheres per cull tile, as in the JAX package (a SPHERE_PAD divisor)
BLOCK_N = 128
# triangles per list tile, as in the JAX package (a TRI_PAD divisor)
TRI_BLOCK_M = 128


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def nrm3_fwd(x, y, z):
    """``ops/vec.normalize_eps`` on three rows -> (yx, yy, yz, inv, ok),
    with inv and ok kept for the transpose."""
    lsq = _dot3(x, y, z, x, y, z)
    ok = lsq > _EPS
    inv = 1.0 / sqrt_f32(torch.where(ok, lsq, 1.0))
    return (torch.where(ok, x * inv, 0.0), torch.where(ok, y * inv, 0.0),
            torch.where(ok, z * inv, 0.0), inv, ok)


def nrm3_bwd(yx, yy, yz, inv, ok, gx, gy, gz):
    """Transpose of normalize_eps given its forward's (y, inv, ok):
    d_x = where(ok, (g - y (y.g)) inv, 0)."""
    s = _dot3(yx, yy, yz, gx, gy, gz)
    return (torch.where(ok, (gx - yx * s) * inv, 0.0),
            torch.where(ok, (gy - yy * s) * inv, 0.0),
            torch.where(ok, (gz - yz * s) * inv, 0.0))


def _payload(o, d, cen, r):
    """Sphere payload recompute -> (m, tp, p, dsq, xx, inside, t)."""
    m0, m1, m2 = cen[0] - o[0], cen[1] - o[1], cen[2] - o[2]
    tp = _dot3(m0, m1, m2, d[0], d[1], d[2])
    p0, p1, p2 = m0 - d[0] * tp, m1 - d[1] * tp, m2 - d[2] * tp
    dsq = _dot3(p0, p1, p2, p0, p1, p2)
    xx = safe_sqrt(r * r - dsq)
    tn = tp - xx
    inside = tn < _EPS
    t = torch.where(inside, tp + xx, tn)
    return (m0, m1, m2), tp, (p0, p1, p2), dsq, xx, inside, t


def _schlick_reflect(ri, cos_t, sin_t, inside, rrefl):
    cant = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    r1 = 1.0 - cos_t
    r1 = r1 * r1 * r1 * r1 * r1
    schlick = r0 + (1.0 - r0) * r1
    return (cant | (schlick > rrefl)) & ~inside


def _tri_plane(o, d, w, is_tri):
    """The plane form of a triangle winner (n in w[0:3], k in w[3]) ->
    (n.d, n.o, den, t = (k - n.o) / den); den is n.d on triangle lanes
    where it is nonzero, else 1 (JAX guards only n.d = 0; on sphere lanes
    the value is discarded, and a finite one keeps autograd free of
    inf * 0)."""
    nd = _dot3(d[0], d[1], d[2], w[0], w[1], w[2])
    no = _dot3(o[0], o[1], o[2], w[0], w[1], w[2])
    den = torch.where(is_tri & (nd != 0.0), nd, 1.0)
    return nd, no, den, (w[3] - no) / den


def shade_plain(st, winner, live, sky, rand, use_sky: bool, is_tri=None):
    """One bounce's smooth state update given the winner (JAX ``_shade``).

    st [16,R], winner [>=12,R] (garbage on lanes that are not live: every
    row it feeds is masked), live / sky [R] bool (alive & hit, alive &
    miss), rand = (r0, r1, r2, r_reflect) [R] each, is_tri: None for a
    sphere scene, else [R] bool (the winner is a triangle: t in the plane
    form, the normal n, inside = backface). -> [16,R].
    Differentiable w.r.t. st and winner under torch.autograd."""
    o, d, a = st[0:3], st[3:6], st[6:9]
    c0, c1, c2 = st[9], st[10], st[11]
    al, em = winner[4:7], winner[7:10]
    spec, ior = winner[10], winner[11]

    if use_sky:
        # ops/shade.sky_color(d) * atten
        sa = (d[1] + 1.0) * 0.5
        oma = 1.0 - sa
        c0 = c0 + torch.where(sky, (oma * 1.0 + sa * 0.5) * a[0], 0.0)
        c1 = c1 + torch.where(sky, (oma * 1.0 + sa * 0.7) * a[1], 0.0)
        c2 = c2 + torch.where(sky, (oma * 1.0 + sa * 1.0) * a[2], 0.0)

    (m0, m1, m2), _, _, _, _, inside, t = _payload(o, d, winner[0:3],
                                                   winner[3])
    pt0, pt1, pt2 = d[0] * t, d[1] * t, d[2] * t
    nr0, nr1, nr2 = pt0 - m0, pt1 - m1, pt2 - m2
    if is_tri is not None:
        nd, _, _, t_t = _tri_plane(o, d, winner, is_tri)
        t = torch.where(is_tri, t_t, t)
        inside = torch.where(is_tri, nd > 0.0, inside)
        nr0 = torch.where(is_tri, winner[0], nr0)
        nr1 = torch.where(is_tri, winner[1], nr1)
        nr2 = torch.where(is_tri, winner[2], nr2)
        pt0, pt1, pt2 = d[0] * t, d[1] * t, d[2] * t
    no0, no1, no2 = o[0] + pt0, o[1] + pt1, o[2] + pt2

    c0 = c0 + torch.where(live, em[0] * a[0], 0.0)
    c1 = c1 + torch.where(live, em[1] * a[1], 0.0)
    c2 = c2 + torch.where(live, em[2] * a[2], 0.0)
    a0 = torch.where(live, a[0] * al[0], a[0])
    a1 = torch.where(live, a[1] * al[1], a[1])
    a2 = torch.where(live, a[2] * al[2], a[2])

    # ops/shade.scatter_direction
    nx, ny, nz, _, _ = nrm3_fwd(nr0, nr1, nr2)
    dn2 = 2.0 * _dot3(d[0], d[1], d[2], nx, ny, nz)
    pu0, pu1, pu2 = d[0] - dn2 * nx, d[1] - dn2 * ny, d[2] - dn2 * nz
    n20 = torch.where(inside, -nx, nx)
    n21 = torch.where(inside, -ny, ny)
    n22 = torch.where(inside, -nz, nz)

    ru0, ru1, ru2, _, _ = nrm3_fwd(rand[0], rand[1], rand[2])
    om = 1.0 - spec
    dd0, dd1, dd2, _, _ = nrm3_fwd(om * (n20 + ru0) + spec * pu0,
                                   om * (n21 + ru1) + spec * pu1,
                                   om * (n22 + ru2) + spec * pu2)

    is_diel = ior != 0.0
    ior_safe = torch.where(is_diel, ior, 1.0)
    ri = torch.where(inside, ior_safe, 1.0 / ior_safe)
    cos_t = torch.clamp_max(_dot3(-d[0], -d[1], -d[2], n20, n21, n22), 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    pe0 = ri * (d[0] + cos_t * n20)
    pe1 = ri * (d[1] + cos_t * n21)
    pe2 = ri * (d[2] + cos_t * n22)
    par = -safe_sqrt(torch.abs(1.0 - _dot3(pe0, pe1, pe2, pe0, pe1, pe2)))
    rf0, rf1, rf2, _, _ = nrm3_fwd(pe0 + par * n20, pe1 + par * n21,
                                   pe2 + par * n22)
    refl = _schlick_reflect(ri, cos_t, sin_t, inside, rand[3])
    nd0 = torch.where(is_diel, torch.where(refl, pu0, rf0), dd0)
    nd1 = torch.where(is_diel, torch.where(refl, pu1, rf1), dd1)
    nd2 = torch.where(is_diel, torch.where(refl, pu2, rf2), dd2)

    return torch.stack([
        torch.where(live, no0, o[0]), torch.where(live, no1, o[1]),
        torch.where(live, no2, o[2]),
        torch.where(live, nd0, d[0]), torch.where(live, nd1, d[1]),
        torch.where(live, nd2, d[2]),
        a0, a1, a2, c0, c1, c2,
        live.to(st.dtype), st[13], st[14], st[15]])


def shade_vjp_plain(st, winner, live, sky, rand, use_sky: bool, g,
                    is_tri=None):
    """Hand transpose of ``shade_plain`` (JAX ``_shade_vjp``, with its
    triangle branch where is_tri is given): recompute the forward's
    primals and push the cotangent g [16,R] (rows 12-15 ignored) back ->
    (d_st [16,R], d_winner [12,R]).

    d_st rows 9-11 are g's (colour passes straight through), rows 12-15
    zero. Paths whose only consumer is a boolean (Schlick, sin_t, the
    total-reflection test) carry no cotangent and are skipped."""
    o0, o1, o2 = st[0], st[1], st[2]
    d0, d1, d2 = st[3], st[4], st[5]
    a0, a1, a2 = st[6], st[7], st[8]
    r_ = winner[3]
    al0, al1, al2 = winner[4], winner[5], winner[6]
    em0, em1, em2 = winner[7], winner[8], winner[9]
    spec, ior = winner[10], winner[11]
    zero = torch.zeros_like(o0)

    # ---- forward recompute, in shade_plain's op order ----
    (m0, m1, m2), tp, (p0, p1, p2), _, xx, inside, tt = _payload(
        st[0:3], st[3:6], winner[0:3], r_)
    qpos = xx > 0.0
    nr0, nr1, nr2 = d0 * tt - m0, d1 * tt - m1, d2 * tt - m2
    if is_tri is not None:
        nd, no, den, t_t = _tri_plane(st[0:3], st[3:6], winner, is_tri)
        tt = torch.where(is_tri, t_t, tt)
        inside = torch.where(is_tri, nd > 0.0, inside)
        nr0 = torch.where(is_tri, winner[0], nr0)
        nr1 = torch.where(is_tri, winner[1], nr1)
        nr2 = torch.where(is_tri, winner[2], nr2)
    nx, ny, nz, n_inv, n_ok = nrm3_fwd(nr0, nr1, nr2)
    dn = _dot3(d0, d1, d2, nx, ny, nz)
    dn2 = 2.0 * dn
    pu0, pu1, pu2 = d0 - dn2 * nx, d1 - dn2 * ny, d2 - dn2 * nz
    sgn = torch.where(inside, -1.0, 1.0)
    t20 = torch.where(inside, -nx, nx)
    t21 = torch.where(inside, -ny, ny)
    t22 = torch.where(inside, -nz, nz)
    ru0, ru1, ru2, _, _ = nrm3_fwd(rand[0], rand[1], rand[2])
    rb0, rb1, rb2 = t20 + ru0, t21 + ru1, t22 + ru2
    om = 1.0 - spec
    ddx, ddy, ddz, dd_inv, dd_ok = nrm3_fwd(
        om * rb0 + spec * pu0, om * rb1 + spec * pu1, om * rb2 + spec * pu2)
    is_diel = ior != 0.0
    ior_safe = torch.where(is_diel, ior, 1.0)
    ri = torch.where(inside, ior_safe, 1.0 / ior_safe)
    uu = _dot3(-d0, -d1, -d2, t20, t21, t22)
    cos_t = torch.clamp_max(uu, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    pe0 = ri * (d0 + cos_t * t20)
    pe1 = ri * (d1 + cos_t * t21)
    pe2 = ri * (d2 + cos_t * t22)
    wv = 1.0 - _dot3(pe0, pe1, pe2, pe0, pe1, pe2)
    sq = safe_sqrt(torch.abs(wv))
    zpos = sq > 0.0
    par = -sq
    rfx, rfy, rfz, rf_inv, rf_ok = nrm3_fwd(
        pe0 + par * t20, pe1 + par * t21, pe2 + par * t22)
    refl = _schlick_reflect(ri, cos_t, sin_t, inside, rand[3])

    # ---- transpose ----
    g_no0 = torch.where(live, g[0], 0.0)
    g_no1 = torch.where(live, g[1], 0.0)
    g_no2 = torch.where(live, g[2], 0.0)
    g_nd0 = torch.where(live, g[3], 0.0)
    g_nd1 = torch.where(live, g[4], 0.0)
    g_nd2 = torch.where(live, g[5], 0.0)
    g_a0, g_a1, g_a2 = g[6], g[7], g[8]
    g_c0, g_c1, g_c2 = g[9], g[10], g[11]
    d_o0 = torch.where(live, 0.0, g[0])
    d_o1 = torch.where(live, 0.0, g[1])
    d_o2 = torch.where(live, 0.0, g[2])
    d_d0 = torch.where(live, 0.0, g[3])
    d_d1 = torch.where(live, 0.0, g[4])
    d_d2 = torch.where(live, 0.0, g[5])

    # c' = c + em*a; a' = a*al
    d_em0 = torch.where(live, g_c0 * a0, 0.0)
    d_em1 = torch.where(live, g_c1 * a1, 0.0)
    d_em2 = torch.where(live, g_c2 * a2, 0.0)
    d_al0 = torch.where(live, g_a0 * a0, 0.0)
    d_al1 = torch.where(live, g_a1 * a1, 0.0)
    d_al2 = torch.where(live, g_a2 * a2, 0.0)
    d_a0 = torch.where(live, g_a0 * al0 + g_c0 * em0, g_a0)
    d_a1 = torch.where(live, g_a1 * al1 + g_c1 * em1, g_a1)
    d_a2 = torch.where(live, g_a2 * al2 + g_c2 * em2, g_a2)
    if use_sky:
        sa = (d1 + 1.0) * 0.5
        d_a0 = d_a0 + torch.where(sky, (1.0 - 0.5 * sa) * g_c0, 0.0)
        d_a1 = d_a1 + torch.where(sky, (1.0 - 0.3 * sa) * g_c1, 0.0)
        d_a2 = d_a2 + torch.where(sky, g_c2, 0.0)
        d_d1 = d_d1 + torch.where(
            sky, (-0.25 * a0) * g_c0 - (0.15 * a1) * g_c1, 0.0)

    # ndir = where(is_diel, where(refl, pure, rf), dd)
    d_dl0 = torch.where(is_diel, g_nd0, 0.0)
    d_dl1 = torch.where(is_diel, g_nd1, 0.0)
    d_dl2 = torch.where(is_diel, g_nd2, 0.0)
    g_dd0 = torch.where(is_diel, 0.0, g_nd0)
    g_dd1 = torch.where(is_diel, 0.0, g_nd1)
    g_dd2 = torch.where(is_diel, 0.0, g_nd2)
    d_pu0 = torch.where(refl, d_dl0, 0.0)
    d_pu1 = torch.where(refl, d_dl1, 0.0)
    d_pu2 = torch.where(refl, d_dl2, 0.0)
    g_rf0 = torch.where(refl, 0.0, d_dl0)
    g_rf1 = torch.where(refl, 0.0, d_dl1)
    g_rf2 = torch.where(refl, 0.0, d_dl2)

    # rf = nrm(pf), pf = perp + par*n2
    d_pe0, d_pe1, d_pe2 = nrm3_bwd(rfx, rfy, rfz, rf_inv, rf_ok,
                                   g_rf0, g_rf1, g_rf2)
    d_par = _dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2)
    d_t20, d_t21, d_t22 = par * d_pe0, par * d_pe1, par * d_pe2
    # par = -sqrt(|1 - perp.perp|)
    d_z = torch.where(zpos, -d_par / (2.0 * torch.where(zpos, sq, 1.0)),
                      0.0)
    d_psq = -torch.sign(wv) * d_z
    d_pe0 = d_pe0 + (2.0 * pe0) * d_psq
    d_pe1 = d_pe1 + (2.0 * pe1) * d_psq
    d_pe2 = d_pe2 + (2.0 * pe2) * d_psq
    # perp = ri*(d + cos_t*n2)
    d_ri = _dot3(d0 + cos_t * t20, d1 + cos_t * t21, d2 + cos_t * t22,
                 d_pe0, d_pe1, d_pe2)
    d_d0 = d_d0 + ri * d_pe0
    d_d1 = d_d1 + ri * d_pe1
    d_d2 = d_d2 + ri * d_pe2
    d_cos = ri * _dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2)
    ric = ri * cos_t
    d_t20 = d_t20 + ric * d_pe0
    d_t21 = d_t21 + ric * d_pe1
    d_t22 = d_t22 + ric * d_pe2
    # cos_t = min(-(d.n2), 1)
    d_u = torch.where(uu <= 1.0, d_cos, 0.0)
    d_d0 = d_d0 - t20 * d_u
    d_d1 = d_d1 - t21 * d_u
    d_d2 = d_d2 - t22 * d_u
    d_t20 = d_t20 - d0 * d_u
    d_t21 = d_t21 - d1 * d_u
    d_t22 = d_t22 - d2 * d_u
    # ri = where(inside, ior_safe, 1/ior_safe)
    d_iorsafe = torch.where(inside, d_ri, -d_ri / (ior_safe * ior_safe))
    d_ior = torch.where(is_diel, d_iorsafe, 0.0)
    # dd = nrm(om*rb + spec*pure), rb = n2 + ru (ru constant)
    d_mx0, d_mx1, d_mx2 = nrm3_bwd(ddx, ddy, ddz, dd_inv, dd_ok,
                                   g_dd0, g_dd1, g_dd2)
    d_spec = _dot3(pu0 - rb0, pu1 - rb1, pu2 - rb2, d_mx0, d_mx1, d_mx2)
    d_t20 = d_t20 + om * d_mx0
    d_t21 = d_t21 + om * d_mx1
    d_t22 = d_t22 + om * d_mx2
    d_pu0 = d_pu0 + spec * d_mx0
    d_pu1 = d_pu1 + spec * d_mx1
    d_pu2 = d_pu2 + spec * d_mx2
    # pure = d - (2 dn) n
    d_d0 = d_d0 + d_pu0
    d_d1 = d_d1 + d_pu1
    d_d2 = d_d2 + d_pu2
    d_dn = -2.0 * _dot3(nx, ny, nz, d_pu0, d_pu1, d_pu2)
    d_nx = -dn2 * d_pu0
    d_ny = -dn2 * d_pu1
    d_nz = -dn2 * d_pu2
    # n2 = sgn*n
    d_nx = d_nx + sgn * d_t20
    d_ny = d_ny + sgn * d_t21
    d_nz = d_nz + sgn * d_t22
    # dn = d.n
    d_d0 = d_d0 + nx * d_dn
    d_d1 = d_d1 + ny * d_dn
    d_d2 = d_d2 + nz * d_dn
    d_nx = d_nx + d0 * d_dn
    d_ny = d_ny + d1 * d_dn
    d_nz = d_nz + d2 * d_dn
    # n = nrm(nr)
    d_nr0, d_nr1, d_nr2 = nrm3_bwd(nx, ny, nz, n_inv, n_ok, d_nx, d_ny, d_nz)

    # no = o + d*tt
    d_o0 = d_o0 + g_no0
    d_o1 = d_o1 + g_no1
    d_o2 = d_o2 + g_no2
    d_d0 = d_d0 + g_no0 * tt
    d_d1 = d_d1 + g_no1 * tt
    d_d2 = d_d2 + g_no2 * tt
    d_tt = _dot3(d0, d1, d2, g_no0, g_no1, g_no2)
    if is_tri is not None:
        # triangle lanes: nr = n, tt = (k - n.o) / den (the plane form)
        d_wt0 = torch.where(is_tri, d_nr0, 0.0)
        d_wt1 = torch.where(is_tri, d_nr1, 0.0)
        d_wt2 = torch.where(is_tri, d_nr2, 0.0)
        d_nr0 = torch.where(is_tri, 0.0, d_nr0)
        d_nr1 = torch.where(is_tri, 0.0, d_nr1)
        d_nr2 = torch.where(is_tri, 0.0, d_nr2)
        d_tt_t = torch.where(is_tri, d_tt, 0.0)
        d_tt = torch.where(is_tri, 0.0, d_tt)
        d_rt = d_tt_t / den
        d_no = -d_tt_t / den
        d_den = -(r_ - no) / (den * den) * d_tt_t
        d_nd = torch.where(is_tri & (nd != 0.0), d_den, 0.0)
        d_o0 = d_o0 + d_no * winner[0]
        d_o1 = d_o1 + d_no * winner[1]
        d_o2 = d_o2 + d_no * winner[2]
        d_d0 = d_d0 + d_nd * winner[0]
        d_d1 = d_d1 + d_nd * winner[1]
        d_d2 = d_d2 + d_nd * winner[2]
        d_wt0 = d_wt0 + d_no * o0 + d_nd * d0
        d_wt1 = d_wt1 + d_no * o1 + d_nd * d1
        d_wt2 = d_wt2 + d_no * o2 + d_nd * d2
    # nr = d*tt - m
    d_d0 = d_d0 + d_nr0 * tt
    d_d1 = d_d1 + d_nr1 * tt
    d_d2 = d_d2 + d_nr2 * tt
    d_tt = d_tt + _dot3(d0, d1, d2, d_nr0, d_nr1, d_nr2)
    d_m0, d_m1, d_m2 = -d_nr0, -d_nr1, -d_nr2
    # tt = where(inside, tp + xx, tp - xx)
    d_tp = d_tt
    d_xx = torch.where(inside, d_tt, -d_tt)
    # xx = safe_sqrt(r^2 - p.p)
    d_q = torch.where(qpos, d_xx / (2.0 * torch.where(qpos, xx, 1.0)), 0.0)
    d_r = (2.0 * r_) * d_q
    d_p0, d_p1, d_p2 = (-2.0 * p0) * d_q, (-2.0 * p1) * d_q, (-2.0 * p2) * d_q
    # p = m - d*tp
    d_m0 = d_m0 + d_p0
    d_m1 = d_m1 + d_p1
    d_m2 = d_m2 + d_p2
    d_d0 = d_d0 - d_p0 * tp
    d_d1 = d_d1 - d_p1 * tp
    d_d2 = d_d2 - d_p2 * tp
    d_tp = d_tp - _dot3(d0, d1, d2, d_p0, d_p1, d_p2)
    # tp = m.d
    d_m0 = d_m0 + d0 * d_tp
    d_m1 = d_m1 + d1 * d_tp
    d_m2 = d_m2 + d2 * d_tp
    d_d0 = d_d0 + m0 * d_tp
    d_d1 = d_d1 + m1 * d_tp
    d_d2 = d_d2 + m2 * d_tp
    # m = cen - o
    d_o0 = d_o0 - d_m0
    d_o1 = d_o1 - d_m1
    d_o2 = d_o2 - d_m2
    if is_tri is not None:
        d_m0, d_m1, d_m2 = d_wt0 + d_m0, d_wt1 + d_m1, d_wt2 + d_m2
        d_r = d_rt + d_r

    d_st = torch.stack([d_o0, d_o1, d_o2, d_d0, d_d1, d_d2, d_a0, d_a1,
                        d_a2, g_c0, g_c1, g_c2, zero, zero, zero, zero])
    d_winner = torch.stack([d_m0, d_m1, d_m2, d_r, d_al0, d_al1, d_al2,
                            d_em0, d_em1, d_em2, d_spec, d_ior])
    return d_st, d_winner


# ---------------------------------------------------------------------------
# Morton permutation and tile culling (host side, no gradient)
# ---------------------------------------------------------------------------

def _spread3(x):
    """10-bit ints (int64 carriers) -> bits spread to every 3rd position."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_codes(c, valid):
    v3 = valid[:, None]
    lo = torch.where(v3, c, _MAX).amin(dim=0)
    hi = torch.where(v3, c, -_MAX).amax(dim=0)
    ext = torch.clamp_min(hi - lo, 1e-20)
    q = torch.clamp((c - lo) / ext * 1024.0, 0.0, 1023.0).to(torch.int64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
            | (_spread3(q[:, 2]) << 2))
    return torch.where(valid, code, 0xFFFFFFFF)


@torch.no_grad()
def morton_perm(scene: Scene):
    """Spatial (Morton / Z-order) sphere permutation -> [N] int64.

    Sorting by the 30-bit Morton code of the quantised centre makes each
    BLOCK_N-sphere tile spatially compact, so the cull mask can skip it;
    padding spheres (radius <= 0) sort last, ties keep scene order. The
    permutation changes no hit except an exact tie in t between two
    spheres, where the lower index in permuted order wins."""
    return torch.argsort(_morton_codes(scene.center, scene.radius > 0.0),
                         stable=True)


def permute_spheres(scene: Scene, perm) -> Scene:
    """The scene with its per-sphere arrays reordered by perm. Autograd
    carries cotangents back through the gather."""
    return dataclasses.replace(
        scene, center=scene.center[perm], radius=scene.radius[perm],
        albedo=scene.albedo[perm], emissive=scene.emissive[perm],
        specular=scene.specular[perm], ior=scene.ior[perm])


@torch.no_grad()
def tri_morton_perm(tris: Triangles):
    """Morton permutation of a triangle soup by centroid -> [M] int64;
    degenerate padding triangles (e1 = e2 = 0) sort last, ties keep
    scene order."""
    valid = (tris.e1 * tris.e1 + tris.e2 * tris.e2).sum(dim=1) > 0.0
    centroid = tris.v0 + (tris.e1 + tris.e2) * (1.0 / 3.0)
    return torch.argsort(_morton_codes(centroid, valid), stable=True)


def permute_tris(tris: Triangles, perm) -> Triangles:
    """The soup with its per-triangle arrays reordered by perm (autograd
    carries cotangents back through the gather)."""
    return dataclasses.replace(
        tris, v0=tris.v0[perm], e1=tris.e1[perm], e2=tris.e2[perm],
        albedo=tris.albedo[perm], emissive=tris.emissive[perm],
        specular=tris.specular[perm], ior=tris.ior[perm])


def permute_scene(scene: Scene) -> Scene:
    """The scene Morton-permuted, spheres and (when present) triangles, as
    both fused routes of the JAX package run it (``permute_scene``). An
    exact tie in t then goes to the lower permuted id."""
    scene = permute_spheres(scene, morton_perm(scene))
    if scene.tris is not None:
        scene = dataclasses.replace(
            scene, tris=permute_tris(scene.tris, tri_morton_perm(scene.tris)))
    return scene


def prim_table(scene: Scene):
    """[P,12] winner table over the one primitive id space, P = N + M:
    the sphere rows (``scene_table``), then a row per triangle [n = e1 x e2
    (3), k = n . v0, albedo (3), emissive (3), specular, ior], the plane
    form whose (n, k) sit in the sphere's (centre, radius) slots (JAX
    ``prim_table``). Differentiable: vertex cotangents flow back through
    the cross and dot products. Padding triangles get n = 0, k = 0 and are
    never winners."""
    sph = scene_table(scene)
    if scene.tris is None:
        return sph
    t = scene.tris
    n = cross(t.e1, t.e2)
    k = _dot3(n[:, 0], n[:, 1], n[:, 2], t.v0[:, 0], t.v0[:, 1], t.v0[:, 2])
    return torch.cat([sph, torch.cat([
        n, k[:, None], t.albedo, t.emissive, t.specular[:, None],
        t.ior[:, None]], dim=1)])


# the JAX package's residency rule (bounce_step.py resident_tables_fit):
# its resident search tables in bf16 must fit a 10 MiB VMEM budget and the
# sphere tile 1024 spheres. The port routes triangle scenes by the same
# rule, so both packages take and refuse the same scenes.
_RESIDENT_VMEM_BUDGET = 10 * 1024 * 1024
_SPH_TILE_MAX = 1024


def resident_tables_fit(n_pad: int, m_pad: int) -> bool:
    """Does a scene of n_pad spheres and m_pad triangles (both padded) take
    the resident-table routes? trimesh (128, 10368) does; bigmesh does
    not. False for a scene without triangles, as in the JAX package."""
    p_pad = n_pad + m_pad
    return (n_pad <= _SPH_TILE_MAX and m_pad > 0 and
            (4 * m_pad * 96 + 2 * n_pad * 54 + 48 * p_pad) * 2
            < _RESIDENT_VMEM_BUDGET)


@torch.no_grad()
def tile_bounds(scene: Scene, block_n: int = BLOCK_N):
    """Radius-inflated boxes of the sphere tiles -> (lo [T,3], hi [T,3]),
    T = ceil(N / block_n). Padding spheres are left out, so an all-padding
    tile gets an empty box (lo > hi) that every ray block culls."""
    c, r = scene.center, scene.radius[:, None]
    valid = r > 0.0
    lo = torch.where(valid, c - r, _MAX)
    hi = torch.where(valid, c + r, -_MAX)
    n_t = -(-c.shape[0] // block_n)
    pad = n_t * block_n - c.shape[0]
    lo = torch.cat([lo, lo.new_full((pad, 3), _MAX)])
    hi = torch.cat([hi, hi.new_full((pad, 3), -_MAX)])
    return (lo.reshape(n_t, block_n, 3).amin(dim=1),
            hi.reshape(n_t, block_n, 3).amax(dim=1))


def _blocks(x, block_r: int, fill):
    """[..., R] -> [..., B, block_r], the ragged last block filled."""
    r = x.shape[-1]
    b = -(-r // block_r)
    pad = x.new_full(x.shape[:-1] + (b * block_r - r,), fill)
    return torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (b, block_r))


@torch.no_grad()
def ray_block_bounds(state, block_r: int = BLOCK_R):
    """Alive-masked bounds of each ray block's origins and directions.
    state [16,R] -> (olo, ohi, dlo, dhi) each [B,3], B = ceil(R/block_r).
    An all-dead block gets inverted bounds; its mask row does not matter,
    since its lanes search nothing."""
    alive = _blocks(state[12] > 0.5, block_r, False)[None]   # [1,B,br]
    sv = _blocks(state[0:6], block_r, 0.0)                    # [6,B,br]
    lo = torch.where(alive, sv, _MAX).amin(dim=2).T           # [B,6]
    hi = torch.where(alive, sv, -_MAX).amax(dim=2).T
    return lo[:, 0:3], hi[:, 0:3], lo[:, 3:6], hi[:, 3:6]


@torch.no_grad()
def cull_mask(olo, ohi, dlo, dhi, tlo, thi):
    """Conservative (ray block x tile) reachability -> [B,T] int32.

    With o_k in [olo_k, ohi_k] and d_k in [dlo_k, dhi_k], the points a
    ray of the block reaches on axis k at t >= 0 lie in
    [olo_k + t dlo_k, ohi_k + t dhi_k]; the tile box is reachable iff some
    common t >= 0 meets, on every axis, olo_k + t dlo_k <= thi_k and
    ohi_k + t dhi_k >= tlo_k. A hit lies in its tile's box, so a culled
    tile never holds a lane's nearest hit and a culled bounce is
    bit-identical to an unculled one."""
    inf = float("inf")

    def le_interval(a, b, c):
        # the t >= -inf for which a + t b <= c ([B,1,3] against [1,T,3])
        a, b, c = a[:, None, :], b[:, None, :], c[None, :, :]
        q = (c - a) / torch.where(b == 0.0, 1.0, b)
        never = (b == 0.0) & (a > c)
        lo = torch.where(b < 0.0, q, torch.where(never, inf, -inf))
        hi = torch.where(b > 0.0, q, torch.where(never, -inf, inf))
        return lo, hi

    lo1, hi1 = le_interval(olo, dlo, thi)          # olo + t dlo <= thi
    lo2, hi2 = le_interval(-ohi, -dhi, -tlo)       # ohi + t dhi >= tlo
    t_lo = torch.maximum(lo1.amax(dim=2), lo2.amax(dim=2)).clamp_min(0.0)
    t_hi = torch.minimum(hi1.amin(dim=2), hi2.amin(dim=2))
    return (t_lo <= t_hi).to(torch.int32)


@torch.no_grad()
def octant_occupancy(state, block_r: int = BLOCK_R):
    """[B,8] bool: does ray block b hold an alive ray whose direction lies
    in sign octant k = (dx>=0) + 2 (dy>=0) + 4 (dz>=0)?"""
    alive = _blocks(state[12] > 0.5, block_r, False)
    d = _blocks(state[3:6], block_r, 0.0)
    oct_id = ((d[0] >= 0.0).long() + 2 * (d[1] >= 0.0).long()
              + 4 * (d[2] >= 0.0).long())
    return torch.stack([(alive & (oct_id == k)).any(dim=1)
                        for k in range(8)], dim=1)


@torch.no_grad()
def _octant_mask(state, tlo, thi, block_r: int):
    olo, ohi, dlo, dhi = ray_block_bounds(state, block_r)
    occ = octant_occupancy(state, block_r)
    mask = torch.zeros((olo.shape[0], tlo.shape[0]), dtype=torch.int32,
                       device=state.device)
    for k in range(8):
        box_lo = torch.tensor([0.0 if k & 1 else -1.0,
                               0.0 if k & 2 else -1.0,
                               0.0 if k & 4 else -1.0], device=state.device)
        box_hi = torch.tensor([1.0 if k & 1 else 0.0,
                               1.0 if k & 2 else 0.0,
                               1.0 if k & 4 else 0.0], device=state.device)
        mk = cull_mask(olo, ohi, torch.maximum(dlo, box_lo),
                       torch.minimum(dhi, box_hi), tlo, thi)
        mask = torch.maximum(mask, mk * occ[:, k:k + 1].to(torch.int32))
    return mask


def bounce_cull_mask(scene: Scene, state, block_r: int = BLOCK_R,
                     block_n: int = BLOCK_N):
    """The primary bounce's cull mask [B,T] int32 (JAX
    ``bounce_cull_mask``, spheres)."""
    return cull_mask(*ray_block_bounds(state, block_r),
                     *tile_bounds(scene, block_n))


def bounce_cull_mask_octant(scene: Scene, state, block_r: int = BLOCK_R,
                            block_n: int = BLOCK_N):
    """The secondary bounces' cull mask [B,T] int32: the OR, over the sign
    octants an alive ray of the block occupies, of ``cull_mask`` with the
    block's direction bounds cut to the octant. The plain interval mask
    never culls after a diffuse bounce (a block's directions span
    [-1,1]^3); per octant the direction signs are fixed, so tiles behind
    the block are culled. Conservative for each octant's rays, so still
    bit-identical."""
    return _octant_mask(state, *tile_bounds(scene, block_n), block_r)


@torch.no_grad()
def tri_tile_bounds(tris: Triangles):
    """Boxes of the triangle tiles (the extremes of v0, v0 + e1, v0 + e2)
    -> (lo [T,3], hi [T,3]), T = M / TRI_BLOCK_M. Degenerate padding
    triangles are left out, so an all-padding tile gets an empty box."""
    return _tile_bounds(tris.v0, tris.e1, tris.e2)


def _tile_bounds(v0, e1, e2):
    m, block_m = v0.shape[0], TRI_BLOCK_M
    if m % block_m:
        raise ValueError(f"{m} triangles are not a multiple of {block_m}")
    valid = ((e1 * e1 + e2 * e2).sum(dim=1) > 0.0)[:, None]
    v1, v2 = v0 + e1, v0 + e2
    lo = torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), _MAX)
    hi = torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2), -_MAX)
    n_t = m // block_m
    return (lo.reshape(n_t, block_m, 3).amin(dim=1),
            hi.reshape(n_t, block_m, 3).amax(dim=1))


@torch.no_grad()
def tri_tile_boxes(tris: Triangles):
    """The tile boxes inflated by 1e-4 of their size and magnitude, as one
    [T,6] table (lo, hi): the slab test of ``tri_block_lists`` is then
    conservative against f32 rounding. Empty boxes stay empty."""
    return _inflate(*tri_tile_bounds(tris))


@torch.no_grad()
def tab_tile_boxes(tab):
    """``tri_tile_boxes`` of the triangles of a search table [M,9]
    (``ops/intersect_tri.tri_search_table``: v0|e1|e2), the same values."""
    return _inflate(*_tile_bounds(tab[:, 0:3], tab[:, 3:6], tab[:, 6:9]))


def _inflate(lo, hi):
    span = torch.clamp_min(hi - lo, 0.0)
    pad = 1e-4 * (span + torch.maximum(lo.abs(), hi.abs()) + 1e-6)
    nonempty = lo[:, 0:1] <= hi[:, 0:1]
    return torch.cat([torch.where(nonempty, lo - pad, lo),
                      torch.where(nonempty, hi + pad, hi)], dim=1)


# slab tests of tri_block_lists per chunk of ray blocks: its [b, br, T]
# temporaries stay near 2^22 elements (they are 672 MB each at 1080p)
_LIST_CHUNK_ELEMS = 1 << 22


@torch.no_grad()
def _block_reach(boxes, state, block_r: int = BLOCK_R):
    """[B,T] bool, B = ceil(R / block_r): does an alive lane of ray block b
    meet tile t's box at some t >= 0 (slab test)?"""
    n_t = boxes.shape[0]
    alive = _blocks(state[12] > 0.5, block_r, False)       # [B,br]
    sv = _blocks(state[0:6], block_r, 0.0)                  # [6,B,br]
    big = 3.0e38
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    step = max(1, _LIST_CHUNK_ELEMS // (block_r * max(n_t, 1)))
    reach = []
    for b0 in range(0, alive.shape[0], step):
        sl = slice(b0, b0 + step)
        tl = torch.zeros((1, 1, n_t), dtype=torch.float32,
                         device=state.device)
        th = torch.full_like(tl, big)
        for k in range(3):
            o = sv[k, sl][:, :, None]                       # [b,br,1]
            d = sv[3 + k, sl][:, :, None]
            lok, hik = lo[None, None, :, k], hi[None, None, :, k]
            dz = d == 0.0
            inv = torch.ones_like(d) / torch.where(dz, 1.0, d)
            a0 = (lok - o) * inv
            a1 = (hik - o) * inv
            inside = (o >= lok) & (o <= hik)
            tl = torch.maximum(tl, torch.where(
                dz, torch.where(inside, -big, big), torch.minimum(a0, a1)))
            th = torch.minimum(th, torch.where(
                dz, torch.where(inside, big, -big), torch.maximum(a0, a1)))
        feasible = alive[sl, :, None] & (th >= tl) & (th >= 0.0)
        reach.append(feasible.any(dim=1))
    return torch.cat(reach)


def tri_block_lists(boxes, state, block_r: int = BLOCK_R, group: int = 1):
    """Per-ray-block lists of the reachable triangle tiles (JAX
    ``tri_block_lists``): each alive lane's exact origin and direction
    slab-tested against the [T,6] inflated boxes (``tri_tile_boxes``), OR
    over the lanes of each ray block, and over ``group`` consecutive
    blocks. -> (cnt [B/G,1] i32, lst [B/G,T] i32: the reachable tile ids
    first, ascending, then the others).

    A hit lies on a triangle of its tile, inside the inflated box, so a
    tile that no lane of the block reaches never holds a lane's nearest
    hit; the exception is Möller-Trumbore accepting a grazing hit whose t
    lies outside its tile's box, which a full sweep folds and the list
    skips. K8 builds the same lists at group 1 inside its launch; this is
    its plain version's, and the tests'."""
    reach = _block_reach(boxes, state, block_r)
    if group > 1:
        pad = -reach.shape[0] % group
        reach = torch.cat([reach, reach.new_zeros((pad, reach.shape[1]))])
        reach = reach.reshape(-1, group, reach.shape[1]).any(dim=1)
    cnt = reach.sum(dim=1, dtype=torch.int32)[:, None]
    lst = torch.argsort((~reach).to(torch.uint8), dim=1, stable=True)
    return cnt, lst.to(torch.int32)


# ---------------------------------------------------------------------------
# K4 / K5 / K6 and their plain versions
# ---------------------------------------------------------------------------

def init_state(origins, directions, stream_base):
    """One sample's [16,R] state from its primary rays [R,3] and stream
    bases [R] (unpadded; rows 14-15 zero)."""
    st = torch.zeros((16, origins.shape[0]), dtype=torch.float32,
                     device=origins.device)
    st[0:3] = origins.T
    st[3:6] = directions.T
    st[6:9] = 1.0
    st[12] = 1.0
    st[13] = rng.u32_to_bits(stream_base)
    return st


def _draws(state, bounce: int):
    """The four draws of bounce ``bounce`` (JAX ``_rand_draws``)."""
    base = rng.bits_to_u32(state[13].detach())
    return (rng.draw_uniform(base, bounce, 0, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 1, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 2, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 3, 0.0, 1.0))


def _check_bounce_args(state, table):
    dev = state.device
    build.require(state, "state", torch.float32, (16, state.shape[1]), dev)
    build.require(table, "table", torch.float32, (table.shape[0], 12), dev)
    return dev, state.shape[1], table.shape[0]


def _is_tri(idx, n_sph: Optional[int]):
    """Is the winner a triangle (its id at or past the n_sph sphere rows)?
    None for a sphere scene, so the shading takes no triangle branch."""
    return None if n_sph is None else idx >= n_sph


def bounce_replay_plain(state, table, idx, bounce: int, *, use_sky: bool,
                        n_sph: Optional[int] = None):
    """Plain version of K5: the bounce's shading from the winner idx [R]
    (-1: no hit). live = idx >= 0, sky = alive & ~live; a lane that is
    neither keeps its state. n_sph: the sphere rows of a triangle scene's
    table (None for a sphere scene). -> new state [16,R]."""
    live = idx >= 0
    sky = (state[12] > 0.5) & ~live
    winner = table[idx.clamp(min=0).long()].T
    return shade_plain(state, winner, live, sky, _draws(state, bounce),
                       use_sky, _is_tri(idx, n_sph))


def _k4_rows(table, tri, n_sph: Optional[int]):
    """(n_sph, M) of K4's table: every row a sphere without ``tri``; with
    it, the sphere rows before its M triangle rows."""
    m = 0 if tri is None else tri.shape[0]
    want = table.shape[0] - m
    if n_sph is not None and int(n_sph) != want:
        raise ValueError(f"table of {table.shape[0]} rows, {n_sph} spheres, "
                         f"{m} triangles")
    return want, m


@torch.no_grad()
def _k4_search(state, table, mask, tri, n_sph: int, sph, stats,
               block_n: int):
    """K4's winner ids [R] int32 (see ``bounce_fwd_plain``)."""
    o, d = state[0:3].T, state[3:6].T
    if sph is not None:
        from tpu_ray_torch.kernels.regen import culled_sphere_fold
        t, idx, counts = culled_sphere_fold(state, table[:n_sph], sph)
        if stats is not None:
            stats += counts.to(stats.device)
    else:
        allowed = None
        if mask is not None:
            lanes = torch.arange(state.shape[1],
                                 device=state.device) // BLOCK_R
            allowed = (mask[lanes] != 0).repeat_interleave(block_n, dim=1)
            allowed = allowed[:, :n_sph]
        hit = nearest_hit(table[:n_sph, 0:3], table[:n_sph, 3], o, d, allowed)
        t, idx = hit.t, hit.idx.long()
    if tri is not None:
        th = nearest_hit_tri(tri, o, d)
        wins = th.t < t
        t = torch.where(wins, th.t, t)
        idx = torch.where(wins, th.idx.long() + n_sph, idx)
    live = (state[12] > 0.5) & (t < _MAX)
    return torch.where(live, idx, -1).to(torch.int32)


def bounce_fwd_plain(state, table, bounce: int, mask=None, *,
                     use_sky: bool, block_n: int = BLOCK_N, tri=None,
                     n_sph: Optional[int] = None, sph=None, stats=None):
    """Plain version of K4: one bounce of the per-sample state [16,R]
    against the winner table [P,12]. The exact search of
    ``ops/intersect.nearest_hit`` over the spheres: all of them, those of
    the tiles that the lane's ray block keeps in ``mask``
    ([ceil(R/BLOCK_R), ceil(N/block_n)] int32), or, with ``sph`` (the
    Morton tiles of ``regen.sphere_tiles``), the culled fold of
    ``regen.culled_sphere_fold``, which gives the same winners and adds
    its counts (boxes tested, tiles folded, pairs tested) to ``stats``
    (None, or int64 [3]). The triangle mode (``tri`` [M,9], the JAX
    kernel's ``tri_tab``; the table's last M rows are the triangles', the
    first ``n_sph`` the spheres'): then every triangle, a triangle winning
    only with a strictly smaller t (``nearest_prim``), and the triangle
    branch of the shading on a triangle winner. Then the shading.
    -> (new state [16,R], winner idx [R] int32, -1 on a miss or a dead
    lane)."""
    n_sph, _ = _k4_rows(table, tri, n_sph)
    if sph is not None and mask is not None:
        raise ValueError("the sphere tiles cull in place of a mask")
    idx = _k4_search(state, table, mask, tri, n_sph, sph, stats, block_n)
    return bounce_replay_plain(state, table, idx, bounce, use_sky=use_sky,
                               n_sph=None if tri is None else n_sph), idx


def bounce_fwd(state, table, bounce: int, mask=None, *, use_sky: bool,
               block_n: int = BLOCK_N, tri=None, n_sph: Optional[int] = None,
               sph=None, stats=None):
    """K4 (``csrc/bounce.cu``): ``bounce_fwd_plain``'s contract in one
    launch, one thread per lane: the spheres culled by ``sph`` in the
    kernel (K2's fold, the route's search), by ``mask``, or not at all,
    then with ``tri`` every triangle (the triangle mode). ``stats``
    (with ``sph``: int64 [3] on the card) gets the kernel's counts, which
    equal the plain version's. The search is always exact (the JAX
    ``exact_argmin=True``); the route's entry points accept the flag and
    ignore it. CPU tensors take ``bounce_fwd_plain``."""
    if not state.is_cuda:
        return bounce_fwd_plain(state, table, bounce, mask, use_sky=use_sky,
                                block_n=block_n, tri=tri, n_sph=n_sph,
                                sph=sph, stats=stats)
    dev, r, _ = _check_bounce_args(state, table)
    n_sph, m = _k4_rows(table, tri, n_sph)
    n_tiles = -(-n_sph // block_n)
    if mask is not None:
        build.require(mask, "mask", torch.int32, (-(-r // BLOCK_R), n_tiles),
                      dev)
    if tri is not None:
        build.require(tri, "tri", torch.float32, (m, 9), dev)
    sp = (None, None, 0, None, None, 0, 0.0)
    if sph is not None:
        from tpu_ray_torch.kernels.regen import _check_sph
        if mask is not None:
            raise ValueError("the sphere tiles cull in place of a mask")
        _check_sph(sph, table[:n_sph], None, stats, dev)
        sp = (sph.boxes.data_ptr(), sph.starts.data_ptr(),
              sph.boxes.shape[0], sph.gboxes.data_ptr(),
              sph.gstarts.data_ptr(), sph.gboxes.shape[0], float(sph.o_lim))
    elif stats is not None:
        raise ValueError("stats count the culled search: give the sphere "
                         "tiles")
    out = torch.empty_like(state)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_bounce_fwd(
            state.data_ptr(), out.data_ptr(), r, table.data_ptr(), n_sph,
            int(bounce), None if mask is None else mask.data_ptr(), n_tiles,
            int(block_n), *sp, None if tri is None else tri.data_ptr(), m,
            int(bool(use_sky)), None if stats is None else stats.data_ptr(),
            idx.data_ptr(), build.stream_of(state))
    build.check("trt_bounce_fwd", err)
    bounce_fwd.launches += 1
    bounce_fwd.culled_launches += sph is not None
    bounce_fwd.tri_launches += tri is not None
    return out, idx


# launches of every mode, and of the culled sphere search and the
# triangle mode among them
bounce_fwd.launches = 0
bounce_fwd.culled_launches = 0
bounce_fwd.tri_launches = 0


@torch.no_grad()
def nearest_prim(st, table, tri=None, tiles=None, sph=None, stats=None):
    """The exact nearest hit of every lane's ray (st rows 0-5) over the
    spheres (the table's rows before its M triangle rows) and then the
    triangles of tri [M,9] (with ``tiles`` [R, T], only those of the tiles
    the lane's row keeps) -> winner id [R] int64 in the one id space, -1
    on a miss. A triangle wins only with a strictly smaller t, so an exact
    tie goes to the lower id. sph: the sphere rows' Morton tiles
    (``regen.sphere_tiles``), folded by ``regen.culled_sphere_fold``
    (the same winners) for the lanes alive in st[12] only, its counts
    (boxes tested, tiles folded, pairs tested) added to stats (None, or
    int64 [3])."""
    n_sph = table.shape[0] - (0 if tri is None else tri.shape[0])
    o, d = st[0:3].T, st[3:6].T
    if sph is None:
        hit = nearest_hit(table[:n_sph, 0:3], table[:n_sph, 3], o, d)
        t, idx = hit.t, hit.idx.long()
    else:
        from tpu_ray_torch.kernels.regen import culled_sphere_fold
        t, idx, counts = culled_sphere_fold(st, table[:n_sph], sph)
        if stats is not None:
            stats += counts.to(stats.device)
    if tri is not None:
        th = nearest_hit_tri(tri, o, d, tiles)
        wins = th.t < t
        t = torch.where(wins, th.t, t)
        idx = torch.where(wins, th.idx.long() + n_sph, idx)
    return torch.where(t < _MAX, idx, -1)


def bounce_fwd_list_plain(state, table, tri, boxes, bounce: int, *,
                          n_sph: int, use_sky: bool):
    """Plain version of K8: one bounce of the per-sample state [16,R] of a
    triangle scene. table [P,12] (n_sph sphere rows, then a row per
    triangle), tri [M,9] its triangles' search table, boxes [T,6]
    (``tri_tile_boxes``). Each alive lane takes the exact nearest sphere,
    then the nearest triangle of the tiles its BLOCK_R-lane block lists
    (``tri_block_lists``), which wins only with a strictly smaller t;
    then the shading. -> (new state [16,R], winner idx [R] int32, -1 on a
    miss or a dead lane)."""
    lanes = torch.arange(state.shape[1], device=state.device) // BLOCK_R
    idx = nearest_prim(state, table, tri, _block_reach(boxes, state)[lanes])
    idx = torch.where(state[12] > 0.5, idx, -1).to(torch.int32)
    return bounce_replay_plain(state, table, idx, bounce, use_sky=use_sky,
                               n_sph=n_sph), idx


def bounce_fwd_list(state, table, tri, boxes, bounce: int, *, n_sph: int,
                    use_sky: bool, stats=None):
    """K8 (``csrc/bounce.cu``): ``bounce_fwd_list_plain``'s contract in
    one launch, one thread per lane; each 256-lane block builds its own
    tile list (``tri_block_lists`` at BLOCK_R, group 1) in the launch and
    folds it front to back with an early exit (K2's listed fold). The
    search is always exact (the JAX ``exact_argmin=True``). stats: None,
    or an int64 [3] CUDA tensor the kernel adds its counts to: listed
    tiles summed over the live blocks, live blocks, ray-triangle pairs
    tested. CPU tensors take ``bounce_fwd_list_plain``."""
    if not state.is_cuda:
        if stats is not None:
            raise ValueError("stats are counted by the kernel only")
        return bounce_fwd_list_plain(state, table, tri, boxes, bounce,
                                     n_sph=n_sph, use_sky=use_sky)
    dev, r, n = _check_bounce_args(state, table)
    m, n_tiles = tri.shape[0], boxes.shape[0]
    build.require(tri, "tri", torch.float32, (m, 9), dev)
    build.require(boxes, "boxes", torch.float32, (n_tiles, 6), dev)
    if n_sph + m != n or n_tiles < 1 or m % n_tiles:
        raise ValueError(f"table of {n} rows, {n_sph} spheres, {m} "
                         f"triangles in {n_tiles} tiles")
    if stats is not None:
        build.require(stats, "stats", torch.int64, (3,), dev)
    out = torch.empty_like(state)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_bounce_fwd_list(
            state.data_ptr(), out.data_ptr(), r, table.data_ptr(), n_sph,
            tri.data_ptr(), m, boxes.data_ptr(), n_tiles, m // n_tiles,
            int(bounce), int(bool(use_sky)),
            None if stats is None else stats.data_ptr(), idx.data_ptr(),
            build.stream_of(state))
    build.check("trt_bounce_fwd_list", err)
    bounce_fwd_list.launches += 1
    return out, idx


bounce_fwd_list.launches = 0


def _n_sph(n_sph: Optional[int], table) -> int:
    """The C entry points' sphere count: every row for a sphere scene."""
    return table.shape[0] if n_sph is None else int(n_sph)


def bounce_replay(state, table, idx, bounce: int, *, use_sky: bool,
                  n_sph: Optional[int] = None):
    """K5 (``csrc/bounce.cu``): ``bounce_replay_plain``'s contract in one
    launch; given K4's or K8's idx it gives their state bit for bit. CPU
    tensors take ``bounce_replay_plain``."""
    if not state.is_cuda:
        return bounce_replay_plain(state, table, idx, bounce,
                                   use_sky=use_sky, n_sph=n_sph)
    dev, r, _ = _check_bounce_args(state, table)
    build.require(idx, "idx", torch.int32, (r,), dev)
    out = torch.empty_like(state)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_bounce_replay(
            state.data_ptr(), out.data_ptr(), r, table.data_ptr(),
            _n_sph(n_sph, table), idx.data_ptr(), int(bounce),
            int(bool(use_sky)), build.stream_of(state))
    build.check("trt_bounce_replay", err)
    bounce_replay.launches += 1
    return out


bounce_replay.launches = 0


def bounce_bwd_lanes_plain(state, table, idx, bounce: int, d_out, *,
                           use_sky: bool, n_sph: Optional[int] = None):
    """``bounce_bwd_plain``'s lane terms, d_out left as it is -> (the
    cotangent of the input state [16,R], rows 12-15 zero; d_winner [12,R],
    the cotangent of each lane's winner row, summed into d_table over the
    live lanes)."""
    live = idx >= 0
    sky = (state[12] > 0.5) & ~live
    winner = table[idx.clamp(min=0).long()].T
    d_st, d_wn = shade_vjp_plain(state, winner, live, sky,
                                 _draws(state, bounce), use_sky, d_out,
                                 _is_tri(idx, n_sph))
    d_st[0:9] = torch.where(live | sky, d_st[0:9], d_out[0:9])
    return d_st, d_wn


def bounce_bwd_plain(state, table, idx, bounce: int, d_out, *,
                     use_sky: bool, n_sph: Optional[int] = None):
    """Plain version of K6: the transpose of ``bounce_replay_plain`` at
    the bounce's input state, given its winner idx and the cotangent d_out
    [16,R] of its output (rows 0-11 read). d_out is overwritten with the
    cotangent of the input state (rows 12-15 zero); a lane that neither
    hits nor sees the sky passes it through. -> (d_out, d_table [P,12],
    summed over the live lanes in f64, then rounded)."""
    d_st, d_wn = bounce_bwd_lanes_plain(state, table, idx, bounce, d_out,
                                        use_sky=use_sky, n_sph=n_sph)
    live = idx >= 0
    d_tab = torch.zeros(table.shape, dtype=torch.float64,
                        device=d_out.device)
    d_tab.index_add_(0, idx[live].long(), d_wn[:, live].T.to(torch.float64))
    d_out.copy_(d_st)
    return d_out, d_tab.to(torch.float32)


# the counts of the global-row sum (csrc/shade.cuh trt_row_merge_end):
# steps merged, warp sums staged, partial row entries written, of them
# first touches (the rows touched, summed over the blocks), and the most
# rows one block touched
MERGE_STATS = 5


def table_sum_fixed_order(keys, d_w, n: int, *, threads: int, parts: int,
                          counts: bool = False):
    """d_table [n,12] f32 summed exactly in K3's and K6's fixed order
    (``csrc/shade.cuh``): keys [S,R] int (or [R]) each lane's winner at
    each step, below 0 for none, and d_w [S,12,R] f32 (or [12,R]) its
    cotangent. The lanes fall in tiles of ``threads`` (the block size);
    block k of ``parts`` takes the tiles k, k + parts, ..., each with its
    steps in the given order. At a step, within each warp of 32 lanes the
    lanes of one key are summed in lane order from +0.0; each warp's sum
    is added to block k's partial row in warp order; the rows are summed
    over the blocks in order from +0.0. With counts, also the int64
    [MERGE_STATS] counts of the global-row branch over these steps (the
    kernels skip a tile's steps past its last alive lane, so K3 merges
    fewer steps than this counts)."""
    if keys.dim() == 1:
        keys, d_w = keys[None], d_w[None]
    steps, r = keys.shape
    dev = d_w.device
    n_warps = threads // 32
    tiles = -(-r // threads)
    pad = tiles * threads - r
    k = torch.nn.functional.pad(keys.long(), (0, pad), value=-1).view(
        steps, tiles, n_warps, 32)
    v = torch.nn.functional.pad(d_w.float(), (0, pad)).view(
        steps, 12, tiles, n_warps, 32).permute(0, 2, 3, 4, 1)
    # each lane's leader: the lowest lane of its warp with its key
    lead_of = (k[..., :, None] == k[..., None, :]).int().argmax(-1)
    lanes = torch.arange(32, device=dev)
    leader = (lead_of == lanes) & (k >= 0)
    wsum = torch.zeros_like(v)
    for lane in range(32):
        at = lead_of[..., lane, None, None].expand(*lead_of.shape[:3], 1, 12)
        cur = wsum.gather(3, at)
        new = torch.where((k[..., lane] >= 0)[..., None, None],
                          cur + v[..., lane:lane + 1, :], cur)
        wsum.scatter_(3, at, new)
    acc = torch.zeros((parts, n, 12), dtype=torch.float32, device=dev)
    touched = torch.zeros((parts, n), dtype=torch.bool, device=dev)
    blocks = torch.arange(parts, device=dev)
    for first in range(0, tiles, parts):
        t = blocks + first
        on = t < tiles
        t, blk = t[on], blocks[on]
        for s in range(steps):
            for w in range(n_warps):
                sel = leader[s, t, w]
                b_ = blk[:, None].expand(-1, 32)[sel]
                key = k[s, t, w][sel]
                acc[b_, key] = acc[b_, key] + wsum[s, t, w][sel]
                touched[b_, key] = True
    out = torch.zeros((n, 12), dtype=torch.float32, device=dev)
    for b_ in range(parts):
        out = out + acc[b_]
    if not counts:
        return out
    srt = k.view(steps, tiles, threads).sort(dim=-1).values
    distinct = (((srt[..., 1:] != srt[..., :-1]) & (srt[..., 1:] >= 0))
                .sum() + (srt[..., 0] >= 0).sum())
    per_block = touched.sum(1)
    return out, torch.stack([
        torch.tensor(steps * tiles, device=dev), leader.sum(), distinct,
        per_block.sum(), per_block.max()]).to(torch.int64)


def bounce_bwd(state, table, idx, bounce: int, d_out, *, use_sky: bool,
               n_sph: Optional[int] = None, stats=None):
    """K6 (``csrc/bounce.cu``): ``bounce_bwd_plain``'s contract, d_out
    overwritten in place. d_table is summed in f32 in a fixed order
    (``table_sum_fixed_order``), so it is the same from run to run: each
    block of lanes into its own partial row (in shared memory up to 96
    KB; past it in global memory, one merge a lane tile and only the
    entries it touches written), then over the blocks in a second launch
    that reads only those entries. stats: None, or int64 [MERGE_STATS] on
    the card, added to where the row lies in global memory. CPU tensors
    take ``bounce_bwd_plain`` (stats must be None)."""
    if not d_out.is_cuda:
        if stats is not None:
            raise ValueError("stats are the kernel's: CUDA tensors only")
        return bounce_bwd_plain(state, table, idx, bounce, d_out,
                                use_sky=use_sky, n_sph=n_sph)
    dev, r, n = _check_bounce_args(state, table)
    build.require(idx, "idx", torch.int32, (r,), dev)
    build.require(d_out, "d_out", torch.float32, (16, r), dev)
    if stats is not None:
        build.require(stats, "stats", torch.int64, (MERGE_STATS,), dev)
    lib = build.load()
    parts = lib.trt_bounce_bwd_parts(r, n)
    part = torch.empty((parts, n, 12), dtype=torch.float32, device=dev)
    touched = torch.empty((parts, -(-n // 32)), dtype=torch.int32,
                          device=dev)
    d_table = torch.empty_like(table)
    with torch.cuda.device(dev):
        err = lib.trt_bounce_bwd(
            state.data_ptr(), idx.data_ptr(), table.data_ptr(), n,
            _n_sph(n_sph, table), d_out.data_ptr(), r, int(bounce),
            int(bool(use_sky)), part.data_ptr(), touched.data_ptr(),
            d_table.data_ptr(), None if stats is None else stats.data_ptr(),
            build.stream_of(d_out))
    build.check("trt_bounce_bwd", err)
    bounce_bwd.launches += 1
    return d_out, d_table


bounce_bwd.launches = 0


# ---------------------------------------------------------------------------
# the per-sample trace, forward only and differentiable
# ---------------------------------------------------------------------------

class FusedTables(NamedTuple):
    table: torch.Tensor  # [P,12] winner table of the permuted scene
    use_sky: bool
    # a triangle scene's: the permuted soup's search table [M,9], its
    # inflated tile boxes [M/TRI_BLOCK_M, 6] and the sphere rows of table
    tri: Optional[torch.Tensor] = None
    boxes: Optional[torch.Tensor] = None
    n_sph: Optional[int] = None
    # the Morton sphere tiles of the sphere rows (regen.sphere_tiles), K4's
    # culled search
    sph: Optional["SphereTiles"] = None


def origin_bound(origins) -> float:
    """|o|_inf over the rays' origins [R,3] (0 for none): the camera's
    bound of ``regen.sphere_tiles``, where the primary rays start."""
    return float(origins.detach().abs().max()) if origins.numel() else 0.0


def fused_tables(scene: Scene, bound: float) -> FusedTables:
    """The per-trace constants of the fused route (JAX ``_fused_tables``):
    the scene Morton-permuted (spheres and triangles), its winner table
    (``prim_table``: the plane form for triangles), the triangles' tile
    boxes, and the Morton sphere tiles of its sphere rows for K4's culled
    search (``regen.sphere_tiles``, their origins bounded by ``bound``,
    the camera's |position|_inf (``origin_bound``), as on the regen route;
    a lane whose origin lies past the bound folds every sphere, so the
    bound has no default). Autograd carries the
    table's cotangent back through ``prim_table`` and the permutation to
    the scene. A triangle scene past ``resident_tables_fit`` is refused:
    ``models/path_tracer.render_pixels`` sends it to the probe route."""
    from tpu_ray_torch.kernels.regen import sphere_tiles
    if scene.tris is not None and not resident_tables_fit(
            scene.n_pad, scene.tris.n_pad):
        raise NotImplementedError(
            f"{scene.tris.n_pad} padded triangles are past "
            "resident_tables_fit: the fused route's records are i16 and "
            "its kernels hold the whole table; render_pixels routes such "
            "a scene to the probe route and the streaming triangle search")
    sp = permute_scene(scene)
    table = prim_table(sp)
    tb = FusedTables(table, scene.use_sky,
                     sph=sphere_tiles(table[:sp.n_pad], bound))
    if sp.tris is None:
        return tb
    return tb._replace(tri=tri_search_table(sp.tris),
                       boxes=tri_tile_boxes(sp.tris), n_sph=sp.n_pad)


def _sweep(tb: FusedTables, st, max_bounces: int, record: bool,
           tri_list: bool = True):
    """The bounces of one sample. A sphere scene goes through K4's culled
    search (the sphere tiles ``tb.sph``) at every bounce, so no host mask
    is built. A triangle scene goes through K8 at every bounce or, with
    tri_list=False, through K4's triangle mode (the spheres culled, then
    every triangle). -> (final state, rays_cast [R] int64, winner ids:
    the list of [R] int16, one a bounce, when record)."""
    rays = torch.zeros(st.shape[1], dtype=torch.int64, device=st.device)
    idxs = []
    for b in range(max_bounces):
        rays += st[12] > 0.5
        if tb.tri is not None and tri_list:
            st, idx = bounce_fwd_list(st, tb.table, tb.tri, tb.boxes, b,
                                      n_sph=tb.n_sph, use_sky=tb.use_sky)
        else:
            st, idx = bounce_fwd(st, tb.table, b, use_sky=tb.use_sky,
                                 tri=tb.tri, n_sph=tb.n_sph, sph=tb.sph)
        if record:
            idxs.append(idx.to(torch.int16))
    return st, rays, idxs


def trace_rays_fused(scene: Scene, origins, directions, stream_base,
                     max_bounces: int, cull_secondary: bool = False,
                     tri_list: bool = True):
    """Forward-only per-sample trace, a drop-in for
    ``models/path_tracer.trace_rays`` -> (color [R,3], rays_cast [R]).
    rays_cast adds the alive lanes at the top of each bounce (reference
    main.cpp:390). The scene is Morton-permuted; every bounce's sphere
    search is culled by the Morton sphere tiles in K4, bit-identically,
    so ``cull_secondary`` (JAX's octant mask for bounces 1..) changes
    nothing. A triangle scene's bounces run K8, or with tri_list=False
    K4's triangle mode, JAX's streamed sweep of every triangle: the same
    output but where the lists skip a grazing hit (see ``_sweep``)."""
    del cull_secondary
    with torch.no_grad():
        st, rays, _ = _sweep(fused_tables(scene, origin_bound(origins)),
                             init_state(origins, directions, stream_base),
                             max_bounces, record=False, tri_list=tri_list)
    return st[9:12].T, rays


class FusedSample(torch.autograd.Function):
    """One sample of the per-sample fused route with its hand-written
    backward (the JAX custom VJP of ``make_fused_sample``).

    Differentiable inputs: the permuted [P,12] table and the camera's
    position and look_at; autograd carries the table's cotangent on
    through ``prim_table`` and the permutation to the spheres and the
    triangles' v0/e1/e2 and materials. Forward: raygen, then K4 (or K8 on
    a triangle scene) a bounce; it saves only the [B,R] int16 winner
    stack. Backward: raygen again under autograd, K5 replays the B-1
    later input states, K6 sweeps back from the last bounce, d_table
    summed over the bounces; the ray cotangents go back through raygen to
    the camera. cfg: (width, height, seed, max_bounces, s, tri_list, the
    ``FusedTables`` without its table)."""

    @staticmethod
    def forward(ctx, table, position, look_at, pixel, cfg):
        width, height, seed, max_bounces, s, tri_list, consts = cfg
        o, d, base = camera_rays(Camera(position, look_at), width, height,
                                 pixel, s, seed)
        tb = consts._replace(table=table)
        st, rays, idxs = _sweep(tb, init_state(o, d, base), max_bounces,
                                record=True, tri_list=tri_list)
        stack = (torch.stack(idxs) if idxs else
                 torch.empty((0, pixel.shape[0]), dtype=torch.int16,
                             device=pixel.device))
        ctx.save_for_backward(table, position, look_at, pixel, stack)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(rays)
        return st[9:12].T.contiguous(), rays

    @staticmethod
    def backward(ctx, d_color, _):
        width, height, seed, max_bounces, s = ctx.cfg[:5]
        consts = ctx.cfg[-1]
        kw = dict(use_sky=consts.use_sky, n_sph=consts.n_sph)
        table, position, look_at, pixel, stack = ctx.saved_tensors
        with torch.enable_grad():
            cam = Camera(position.detach().requires_grad_(),
                         look_at.detach().requires_grad_())
            o, d, base = camera_rays(cam, width, height, pixel, s, seed)
        states = [init_state(o.detach(), d.detach(), base)]
        idxs = [stack[b].to(torch.int32) for b in range(max_bounces)]
        for b in range(max_bounces - 1):
            states.append(bounce_replay(states[b], table, idxs[b], b, **kw))
        d_st = torch.zeros_like(states[0])
        d_st[9:12] = d_color.T
        d_table = torch.zeros_like(table)
        for b in reversed(range(max_bounces)):
            _, d_tab = bounce_bwd(states.pop(), table, idxs[b], b, d_st,
                                  **kw)
            d_table += d_tab
        d_pos, d_look = torch.autograd.grad(
            (o, d), (cam.position, cam.look_at), (d_st[0:3].T, d_st[3:6].T))
        return d_table, d_pos, d_look, None, None


def make_fused_sample(width: int, height: int, seed: int, max_bounces: int,
                      cull_secondary: bool = False, tri_list: bool = True):
    """Differentiable per-sample trace: (scene, camera, pixel, s,
    tables=None) -> (color [R,3], rays_cast [R] int64) of sample s for the
    pixel set [R]. ``tables``: ``fused_tables(scene, bound)``, to share
    between the calls of one pass. ``cull_secondary`` changes nothing (see
    ``trace_rays_fused``); tri_list=False takes K4's triangle mode on a
    triangle scene in place of K8, with the same backward.

    Where nothing asks for a gradient this runs the forward alone.
    Otherwise ``FusedSample``, which keeps 2 B per lane and bounce for
    its backward."""
    del cull_secondary
    return _fused_sample(width, height, seed, max_bounces, tri_list)


@functools.lru_cache(maxsize=None)
def _fused_sample(width: int, height: int, seed: int, max_bounces: int,
                  tri_list: bool):
    """``make_fused_sample``'s closure, one a configuration."""

    def sample(scene: Scene, camera: Camera, pixel, s: int, tables=None):
        tb = (fused_tables(scene, origin_bound(camera.position[None]))
              if tables is None else tables)
        if tb.table.shape[0] >= 2 ** 15:
            raise ValueError("winner records are i16: at most 32767 "
                             "primitives")
        leaves = (tb.table, camera.position, camera.look_at)
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in leaves)):
            with torch.no_grad():
                st, rays, _ = _sweep(
                    tb, init_state(*camera_rays(camera, width, height, pixel,
                                                s, seed)),
                    max_bounces, record=False, tri_list=tri_list)
            return st[9:12].T, rays
        cfg = (width, height, seed, max_bounces, int(s), tri_list,
               tb._replace(table=None))
        return FusedSample.apply(*leaves, pixel, cfg)

    return sample
