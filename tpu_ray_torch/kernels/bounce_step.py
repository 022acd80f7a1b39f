"""The per-bounce shading chain and its hand transpose, in plain PyTorch.

Port of the parts of ``tpu_ray/kernels/bounce_step.py`` that the regen
route needs: ``_shade`` (sphere branch; the port has no triangles yet),
``_nrm3_fwd``/``_nrm3_bwd`` and ``_shade_vjp``. The fused per-bounce
kernels of that file (``bounce_fwd``, ``bounce_replay``, ``bounce_bwd``)
are not ported yet (ROADMAP.md queue B items 6-9).

Both functions work on rows: a state ``st`` [16,R] (rows 0-2 origin, 3-5
direction, 6-8 attenuation, 9-11 colour, 12 alive, 13 rng base bits, 14
sample, 15 bounce) and the gathered winner ``winner`` [>=12,R] (rows 0-2
centre, 3 radius, 4-6 albedo, 7-9 emissive, 10 specular, 11 ior: the
columns of ``scene_table``). ``shade_plain`` repeats the f32 op sequence
of ``ops/intersect.hit_payload`` + ``ops/shade.scatter_direction`` (and
of ``csrc/regen_step.cuh``), so the regen forward built on it is bit-equal
to the bounce-loop render. ``shade_vjp_plain`` recomputes those primals
in the same op order and pushes a cotangent back through them; its
op order is repeated by ``csrc/regen_bwd.cu``. Normalisation is the port's
``1 / sqrt`` (``ops/vec.normalize_eps``), not the JAX package's rsqrt.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.core.scene import F32_EPS
from tpu_ray_torch.ops.intersect import payload_tables as scene_table
from tpu_ray_torch.ops.vec import safe_sqrt, sqrt_f32

__all__ = ["shade_plain", "shade_vjp_plain", "nrm3_fwd", "nrm3_bwd",
           "scene_table"]

_EPS = float(F32_EPS)


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


def shade_plain(st, winner, live, sky, rand, use_sky: bool):
    """One bounce's smooth state update given the winner (JAX ``_shade``).

    st [16,R], winner [>=12,R] (garbage on lanes that are not live: every
    row it feeds is masked), live / sky [R] bool (alive & hit, alive &
    miss), rand = (r0, r1, r2, r_reflect) [R] each. -> [16,R].
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
    no0, no1, no2 = o[0] + pt0, o[1] + pt1, o[2] + pt2

    c0 = c0 + torch.where(live, em[0] * a[0], 0.0)
    c1 = c1 + torch.where(live, em[1] * a[1], 0.0)
    c2 = c2 + torch.where(live, em[2] * a[2], 0.0)
    a0 = torch.where(live, a[0] * al[0], a[0])
    a1 = torch.where(live, a[1] * al[1], a[1])
    a2 = torch.where(live, a[2] * al[2], a[2])

    # ops/shade.scatter_direction
    nx, ny, nz, _, _ = nrm3_fwd(pt0 - m0, pt1 - m1, pt2 - m2)
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


def shade_vjp_plain(st, winner, live, sky, rand, use_sky: bool, g):
    """Hand transpose of ``shade_plain`` (JAX ``_shade_vjp``, sphere
    branch): recompute the forward's primals and push the cotangent g
    [16,R] (rows 12-15 ignored) back -> (d_st [16,R], d_winner [12,R]).

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
    pt0, pt1, pt2 = d0 * tt, d1 * tt, d2 * tt
    nx, ny, nz, n_inv, n_ok = nrm3_fwd(pt0 - m0, pt1 - m1, pt2 - m2)
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

    d_st = torch.stack([d_o0, d_o1, d_o2, d_d0, d_d1, d_d2, d_a0, d_a1,
                        d_a2, g_c0, g_c1, g_c2, zero, zero, zero, zero])
    d_winner = torch.stack([d_m0, d_m1, d_m2, d_r, d_al0, d_al1, d_al2,
                            d_em0, d_em1, d_em2, d_spec, d_ior])
    return d_st, d_winner
