// The bounce's shading and its transpose, shared by every kernel that
// shades a ray: K2 (regen.cu, through trt_step_tail), K3 (regen_bwd.cu),
// and K4, K5, K6 (bounce.cu). One copy of each, so the forward, the
// backward's replay and the two backwards repeat one f32 op sequence.
//
// The plain versions are kernels/bounce_step.py shade_plain and
// shade_vjp_plain; this file repeats their op order (see common.cuh on
// -fmad=false). The JAX package shares _shade and _shade_vjp the same way
// (tpu_ray/kernels/bounce_step.py).
#pragma once

#include "common.cuh"

// One bounce's shading of an alive lane (shade_plain): w is the winner's
// row of the [P,12] table (center 0-2, radius 3, albedo 4-6, emissive 7-9,
// specular 10, ior 11; a triangle's row holds its normal n = e1 x e2 in
// 0-2 and k = n . v0 in 3), nullptr on a miss. A miss adds the sky colour
// when use_sky; a hit adds the emission, multiplies in the albedo and
// scatters, with the draws keyed by the lane's stream base and bterm (the
// bounce times TRT_MIX_BOUNCE, core/rng.py slots 0-3). is_tri: the winner
// is a triangle, hit at t = (k - n . o) / (n . d) (the plane form) with
// normal n, inside when it meets the backface (n . d > 0). Lane: any
// struct with the rows ox..cb and base.
template <class Lane>
__device__ __forceinline__ void trt_shade(Lane& L, const float* w,
                                          uint32_t bterm, bool use_sky,
                                          bool is_tri = false) {
  const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
  const float s_01 = 2.3283064365386963e-10f;   // 2^-32
  if (w == nullptr) {
    if (use_sky) {
      // ops/shade.py sky_color(d) * atten
      const float a = (L.dy + 1.0f) * 0.5f;
      const float oma = 1.0f - a;
      L.cr = L.cr + (oma * 1.0f + a * 0.5f) * L.ar;
      L.cg = L.cg + (oma * 1.0f + a * 0.7f) * L.ag;
      L.cb = L.cb + (oma * 1.0f + a * 1.0f) * L.ab;
    }
  } else {
    // ops/intersect.py hit_payload
    const float mx = w[0] - L.ox, my = w[1] - L.oy, mz = w[2] - L.oz;
    const float tp = mx * L.dx + my * L.dy + mz * L.dz;
    const float qx = mx - L.dx * tp, qy = my - L.dy * tp,
                qz = mz - L.dz * tp;
    const float dsq = qx * qx + qy * qy + qz * qz;
    const float x = trt_safe_sqrt(w[3] * w[3] - dsq);
    const float tn = tp - x;
    bool inside = tn < TRT_F32_EPS;
    float t = inside ? tp + x : tn;
    float ptx = L.dx * t, pty = L.dy * t, ptz = L.dz * t;
    float nx = ptx - mx, ny = pty - my, nz = ptz - mz;
    if (is_tri) {
      const float nd = L.dx * w[0] + L.dy * w[1] + L.dz * w[2];
      const float no = L.ox * w[0] + L.oy * w[1] + L.oz * w[2];
      t = (w[3] - no) / (nd != 0.0f ? nd : 1.0f);
      inside = nd > 0.0f;
      nx = w[0]; ny = w[1]; nz = w[2];
      ptx = L.dx * t; pty = L.dy * t; ptz = L.dz * t;
    }
    const float nox = L.ox + ptx, noy = L.oy + pty, noz = L.oz + ptz;

    L.cr = L.cr + w[7] * L.ar;
    L.cg = L.cg + w[8] * L.ag;
    L.cb = L.cb + w[9] * L.ab;
    L.ar = L.ar * w[4];
    L.ag = L.ag * w[5];
    L.ab = L.ab * w[6];
    const float spec = w[10];
    const float eta = w[11];

    // draws keyed by the lane's bounce row (core/rng.py slots 0-3)
    float rx = trt_draw(L.base, bterm, 0u, s_pm1, -1.0f);
    float ry = trt_draw(L.base, bterm, 1u, s_pm1, -1.0f);
    float rz = trt_draw(L.base, bterm, 2u, s_pm1, -1.0f);
    const float rrefl = trt_draw(L.base, bterm, 3u, s_01, 0.0f);

    // ops/shade.py scatter_direction
    trt_normalize_eps(nx, ny, nz);
    const float dn2 = 2.0f * (L.dx * nx + L.dy * ny + L.dz * nz);
    const float purex = L.dx - dn2 * nx, purey = L.dy - dn2 * ny,
                purez = L.dz - dn2 * nz;
    const float n2x = inside ? -nx : nx, n2y = inside ? -ny : ny,
                n2z = inside ? -nz : nz;
    float ndx, ndy, ndz;
    if (eta == 0.0f) {
      trt_normalize_eps(rx, ry, rz);
      const float rbx = n2x + rx, rby = n2y + ry, rbz = n2z + rz;
      const float om = 1.0f - spec;
      ndx = om * rbx + spec * purex;
      ndy = om * rby + spec * purey;
      ndz = om * rbz + spec * purez;
      trt_normalize_eps(ndx, ndy, ndz);
    } else {
      const float ri = inside ? eta : 1.0f / eta;
      const float cdot = (-L.dx) * n2x + (-L.dy) * n2y + (-L.dz) * n2z;
      const float cos_t = fminf(cdot, 1.0f);
      const float sin_t = trt_safe_sqrt(1.0f - cos_t * cos_t);
      const bool cant = ri * sin_t > 1.0f;
      const float perpx = ri * (L.dx + cos_t * n2x);
      const float perpy = ri * (L.dy + cos_t * n2y);
      const float perpz = ri * (L.dz + cos_t * n2z);
      const float par = -trt_safe_sqrt(fabsf(
          1.0f - (perpx * perpx + perpy * perpy + perpz * perpz)));
      float rfx = perpx + par * n2x, rfy = perpy + par * n2y,
            rfz = perpz + par * n2z;
      trt_normalize_eps(rfx, rfy, rfz);
      float r0 = (1.0f - ri) / (1.0f + ri);
      r0 = r0 * r0;
      float r1 = 1.0f - cos_t;
      r1 = r1 * r1 * r1 * r1 * r1;
      const float schlick = r0 + (1.0f - r0) * r1;
      const bool refl = (cant || schlick > rrefl) && !inside;
      ndx = refl ? purex : rfx;
      ndy = refl ? purey : rfy;
      ndz = refl ? purez : rfz;
    }
    L.ox = nox; L.oy = noy; L.oz = noz;
    L.dx = ndx; L.dy = ndy; L.dz = ndz;
  }
}

__device__ __forceinline__ float trt_dot3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// bounce_step.py nrm3_fwd: normalize_eps keeping inv and ok
__device__ __forceinline__ void trt_nrm3_fwd(float x, float y, float z,
                                             float& ox, float& oy, float& oz,
                                             float& inv, bool& ok) {
  const float lsq = trt_dot3(x, y, z, x, y, z);
  ok = lsq > TRT_F32_EPS;
  inv = 1.0f / sqrtf(ok ? lsq : 1.0f);
  ox = ok ? x * inv : 0.0f;
  oy = ok ? y * inv : 0.0f;
  oz = ok ? z * inv : 0.0f;
}

// bounce_step.py nrm3_bwd: d_x = where(ok, (g - y (y.g)) inv, 0)
__device__ __forceinline__ void trt_nrm3_bwd(float yx, float yy, float yz,
                                             float inv, bool ok, float gx,
                                             float gy, float gz, float& dx,
                                             float& dy, float& dz) {
  const float s = trt_dot3(yx, yy, yz, gx, gy, gz);
  dx = ok ? (gx - yx * s) * inv : 0.0f;
  dy = ok ? (gy - yy * s) * inv : 0.0f;
  dz = ok ? (gz - yz * s) * inv : 0.0f;
}

__device__ __forceinline__ float trt_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// bounce_step.py shade_vjp_plain for one lane. s: the pre-bounce rows
// (o 0-2, d 3-5, a 6-8); w: the winner's table row (row 0 on a miss,
// as the plain version gathers; every use is masked); g: cotangent rows
// 0-11. has_tris: the scene has triangles (the plain version's is_tri is
// not None), so the triangle branch's selects run on every lane; is_tri:
// this lane's winner is a triangle. -> d_s rows 0-8 (rows 9-11 are g's)
// and d_w [12].
static __device__ void trt_shade_vjp(const float* s, const float* w,
                                     bool live, bool sky, float rd0,
                                     float rd1, float rd2, float rrefl,
                                     bool use_sky, const float* g, float* d_s,
                                     float* d_w, bool has_tris = false,
                                     bool is_tri = false) {
  const float o0 = s[0], o1 = s[1], o2 = s[2];
  const float d0 = s[3], d1 = s[4], d2 = s[5];
  const float a0 = s[6], a1 = s[7], a2 = s[8];
  const float r_ = w[3];
  const float al0 = w[4], al1 = w[5], al2 = w[6];
  const float em0 = w[7], em1 = w[8], em2 = w[9];
  const float spec = w[10], ior = w[11];

  // ---- forward recompute, in shade_plain's op order ----
  const float m0 = w[0] - o0, m1 = w[1] - o1, m2 = w[2] - o2;
  const float tp = trt_dot3(m0, m1, m2, d0, d1, d2);
  const float p0 = m0 - d0 * tp, p1 = m1 - d1 * tp, p2 = m2 - d2 * tp;
  const float dsq = trt_dot3(p0, p1, p2, p0, p1, p2);
  const float xx = trt_safe_sqrt(r_ * r_ - dsq);
  const float tn = tp - xx;
  bool inside = tn < TRT_F32_EPS;
  float tt = inside ? tp + xx : tn;
  const bool qpos = xx > 0.0f;
  float nr0 = d0 * tt - m0, nr1 = d1 * tt - m1, nr2 = d2 * tt - m2;
  // the plane form on triangle lanes (bounce_step.py _tri_plane)
  float nd = 0.0f, no = 0.0f, den = 1.0f;
  if (has_tris) {
    nd = trt_dot3(d0, d1, d2, w[0], w[1], w[2]);
    no = trt_dot3(o0, o1, o2, w[0], w[1], w[2]);
    den = (is_tri && nd != 0.0f) ? nd : 1.0f;
    const float t_t = (r_ - no) / den;
    if (is_tri) {
      tt = t_t;
      inside = nd > 0.0f;
      nr0 = w[0]; nr1 = w[1]; nr2 = w[2];
    }
  }
  float nx, ny, nz, n_inv;
  bool n_ok;
  trt_nrm3_fwd(nr0, nr1, nr2, nx, ny, nz, n_inv, n_ok);
  const float dn = trt_dot3(d0, d1, d2, nx, ny, nz);
  const float dn2 = 2.0f * dn;
  const float pu0 = d0 - dn2 * nx, pu1 = d1 - dn2 * ny, pu2 = d2 - dn2 * nz;
  const float sgn = inside ? -1.0f : 1.0f;
  const float t20 = inside ? -nx : nx, t21 = inside ? -ny : ny,
              t22 = inside ? -nz : nz;
  float ru0, ru1, ru2, ru_inv;
  bool ru_ok;
  trt_nrm3_fwd(rd0, rd1, rd2, ru0, ru1, ru2, ru_inv, ru_ok);
  const float rb0 = t20 + ru0, rb1 = t21 + ru1, rb2 = t22 + ru2;
  const float om = 1.0f - spec;
  float ddx, ddy, ddz, dd_inv;
  bool dd_ok;
  trt_nrm3_fwd(om * rb0 + spec * pu0, om * rb1 + spec * pu1,
           om * rb2 + spec * pu2, ddx, ddy, ddz, dd_inv, dd_ok);
  const bool is_diel = ior != 0.0f;
  const float ior_safe = is_diel ? ior : 1.0f;
  const float ri = inside ? ior_safe : 1.0f / ior_safe;
  const float uu = trt_dot3(-d0, -d1, -d2, t20, t21, t22);
  const float cos_t = fminf(uu, 1.0f);
  const float sin_t = trt_safe_sqrt(1.0f - cos_t * cos_t);
  const float pe0 = ri * (d0 + cos_t * t20);
  const float pe1 = ri * (d1 + cos_t * t21);
  const float pe2 = ri * (d2 + cos_t * t22);
  const float wv = 1.0f - trt_dot3(pe0, pe1, pe2, pe0, pe1, pe2);
  const float sq = trt_safe_sqrt(fabsf(wv));
  const bool zpos = sq > 0.0f;
  const float par = -sq;
  float rfx, rfy, rfz, rf_inv;
  bool rf_ok;
  trt_nrm3_fwd(pe0 + par * t20, pe1 + par * t21, pe2 + par * t22, rfx, rfy, rfz,
           rf_inv, rf_ok);
  const bool cant = ri * sin_t > 1.0f;
  float sr0 = (1.0f - ri) / (1.0f + ri);
  sr0 = sr0 * sr0;
  float sr1 = 1.0f - cos_t;
  sr1 = sr1 * sr1 * sr1 * sr1 * sr1;
  const float schlick = sr0 + (1.0f - sr0) * sr1;
  const bool refl = (cant || schlick > rrefl) && !inside;

  // ---- transpose ----
  const float g_no0 = live ? g[0] : 0.0f, g_no1 = live ? g[1] : 0.0f,
              g_no2 = live ? g[2] : 0.0f;
  const float g_nd0 = live ? g[3] : 0.0f, g_nd1 = live ? g[4] : 0.0f,
              g_nd2 = live ? g[5] : 0.0f;
  const float g_a0 = g[6], g_a1 = g[7], g_a2 = g[8];
  const float g_c0 = g[9], g_c1 = g[10], g_c2 = g[11];
  float d_o0 = live ? 0.0f : g[0], d_o1 = live ? 0.0f : g[1],
        d_o2 = live ? 0.0f : g[2];
  float d_d0 = live ? 0.0f : g[3], d_d1 = live ? 0.0f : g[4],
        d_d2 = live ? 0.0f : g[5];

  d_w[7] = live ? g_c0 * a0 : 0.0f;
  d_w[8] = live ? g_c1 * a1 : 0.0f;
  d_w[9] = live ? g_c2 * a2 : 0.0f;
  d_w[4] = live ? g_a0 * a0 : 0.0f;
  d_w[5] = live ? g_a1 * a1 : 0.0f;
  d_w[6] = live ? g_a2 * a2 : 0.0f;
  float d_a0 = live ? g_a0 * al0 + g_c0 * em0 : g_a0;
  float d_a1 = live ? g_a1 * al1 + g_c1 * em1 : g_a1;
  float d_a2 = live ? g_a2 * al2 + g_c2 * em2 : g_a2;
  if (use_sky) {
    const float sa = (d1 + 1.0f) * 0.5f;
    d_a0 = d_a0 + (sky ? (1.0f - 0.5f * sa) * g_c0 : 0.0f);
    d_a1 = d_a1 + (sky ? (1.0f - 0.3f * sa) * g_c1 : 0.0f);
    d_a2 = d_a2 + (sky ? g_c2 : 0.0f);
    d_d1 = d_d1 + (sky ? (-0.25f * a0) * g_c0 - (0.15f * a1) * g_c1 : 0.0f);
  }

  const float d_dl0 = is_diel ? g_nd0 : 0.0f, d_dl1 = is_diel ? g_nd1 : 0.0f,
              d_dl2 = is_diel ? g_nd2 : 0.0f;
  const float g_dd0 = is_diel ? 0.0f : g_nd0, g_dd1 = is_diel ? 0.0f : g_nd1,
              g_dd2 = is_diel ? 0.0f : g_nd2;
  float d_pu0 = refl ? d_dl0 : 0.0f, d_pu1 = refl ? d_dl1 : 0.0f,
        d_pu2 = refl ? d_dl2 : 0.0f;
  const float g_rf0 = refl ? 0.0f : d_dl0, g_rf1 = refl ? 0.0f : d_dl1,
              g_rf2 = refl ? 0.0f : d_dl2;

  float d_pe0, d_pe1, d_pe2;
  trt_nrm3_bwd(rfx, rfy, rfz, rf_inv, rf_ok, g_rf0, g_rf1, g_rf2, d_pe0, d_pe1,
           d_pe2);
  const float d_par = trt_dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2);
  float d_t20 = par * d_pe0, d_t21 = par * d_pe1, d_t22 = par * d_pe2;
  const float d_z = zpos ? (-d_par) / (2.0f * sq) : 0.0f;
  const float d_psq = (-trt_sign(wv)) * d_z;
  d_pe0 = d_pe0 + (2.0f * pe0) * d_psq;
  d_pe1 = d_pe1 + (2.0f * pe1) * d_psq;
  d_pe2 = d_pe2 + (2.0f * pe2) * d_psq;
  const float d_ri = trt_dot3(d0 + cos_t * t20, d1 + cos_t * t21,
                          d2 + cos_t * t22, d_pe0, d_pe1, d_pe2);
  d_d0 = d_d0 + ri * d_pe0;
  d_d1 = d_d1 + ri * d_pe1;
  d_d2 = d_d2 + ri * d_pe2;
  const float d_cos = ri * trt_dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2);
  const float ric = ri * cos_t;
  d_t20 = d_t20 + ric * d_pe0;
  d_t21 = d_t21 + ric * d_pe1;
  d_t22 = d_t22 + ric * d_pe2;
  const float d_u = uu <= 1.0f ? d_cos : 0.0f;
  d_d0 = d_d0 - t20 * d_u;
  d_d1 = d_d1 - t21 * d_u;
  d_d2 = d_d2 - t22 * d_u;
  d_t20 = d_t20 - d0 * d_u;
  d_t21 = d_t21 - d1 * d_u;
  d_t22 = d_t22 - d2 * d_u;
  const float d_iorsafe =
      inside ? d_ri : (-d_ri) / (ior_safe * ior_safe);
  d_w[11] = is_diel ? d_iorsafe : 0.0f;
  float d_mx0, d_mx1, d_mx2;
  trt_nrm3_bwd(ddx, ddy, ddz, dd_inv, dd_ok, g_dd0, g_dd1, g_dd2, d_mx0, d_mx1,
           d_mx2);
  d_w[10] = trt_dot3(pu0 - rb0, pu1 - rb1, pu2 - rb2, d_mx0, d_mx1, d_mx2);
  d_t20 = d_t20 + om * d_mx0;
  d_t21 = d_t21 + om * d_mx1;
  d_t22 = d_t22 + om * d_mx2;
  d_pu0 = d_pu0 + spec * d_mx0;
  d_pu1 = d_pu1 + spec * d_mx1;
  d_pu2 = d_pu2 + spec * d_mx2;
  d_d0 = d_d0 + d_pu0;
  d_d1 = d_d1 + d_pu1;
  d_d2 = d_d2 + d_pu2;
  const float d_dn = -2.0f * trt_dot3(nx, ny, nz, d_pu0, d_pu1, d_pu2);
  float d_nx = (-dn2) * d_pu0, d_ny = (-dn2) * d_pu1, d_nz = (-dn2) * d_pu2;
  d_nx = d_nx + sgn * d_t20;
  d_ny = d_ny + sgn * d_t21;
  d_nz = d_nz + sgn * d_t22;
  d_d0 = d_d0 + nx * d_dn;
  d_d1 = d_d1 + ny * d_dn;
  d_d2 = d_d2 + nz * d_dn;
  d_nx = d_nx + d0 * d_dn;
  d_ny = d_ny + d1 * d_dn;
  d_nz = d_nz + d2 * d_dn;
  float d_nr0, d_nr1, d_nr2;
  trt_nrm3_bwd(nx, ny, nz, n_inv, n_ok, d_nx, d_ny, d_nz, d_nr0, d_nr1, d_nr2);

  d_o0 = d_o0 + g_no0;
  d_o1 = d_o1 + g_no1;
  d_o2 = d_o2 + g_no2;
  d_d0 = d_d0 + g_no0 * tt;
  d_d1 = d_d1 + g_no1 * tt;
  d_d2 = d_d2 + g_no2 * tt;
  float d_tt = trt_dot3(d0, d1, d2, g_no0, g_no1, g_no2);
  // triangle lanes: nr = n, tt = (k - n.o) / den
  float d_wt0 = 0.0f, d_wt1 = 0.0f, d_wt2 = 0.0f, d_rt = 0.0f;
  if (has_tris) {
    d_wt0 = is_tri ? d_nr0 : 0.0f;
    d_wt1 = is_tri ? d_nr1 : 0.0f;
    d_wt2 = is_tri ? d_nr2 : 0.0f;
    d_nr0 = is_tri ? 0.0f : d_nr0;
    d_nr1 = is_tri ? 0.0f : d_nr1;
    d_nr2 = is_tri ? 0.0f : d_nr2;
    const float d_tt_t = is_tri ? d_tt : 0.0f;
    d_tt = is_tri ? 0.0f : d_tt;
    d_rt = d_tt_t / den;
    const float d_no = (-d_tt_t) / den;
    const float d_den = ((-(r_ - no)) / (den * den)) * d_tt_t;
    const float d_nd = (is_tri && nd != 0.0f) ? d_den : 0.0f;
    d_o0 = d_o0 + d_no * w[0];
    d_o1 = d_o1 + d_no * w[1];
    d_o2 = d_o2 + d_no * w[2];
    d_d0 = d_d0 + d_nd * w[0];
    d_d1 = d_d1 + d_nd * w[1];
    d_d2 = d_d2 + d_nd * w[2];
    d_wt0 = d_wt0 + d_no * o0 + d_nd * d0;
    d_wt1 = d_wt1 + d_no * o1 + d_nd * d1;
    d_wt2 = d_wt2 + d_no * o2 + d_nd * d2;
  }
  d_d0 = d_d0 + d_nr0 * tt;
  d_d1 = d_d1 + d_nr1 * tt;
  d_d2 = d_d2 + d_nr2 * tt;
  d_tt = d_tt + trt_dot3(d0, d1, d2, d_nr0, d_nr1, d_nr2);
  float d_m0 = -d_nr0, d_m1 = -d_nr1, d_m2 = -d_nr2;
  float d_tp = d_tt;
  const float d_xx = inside ? d_tt : -d_tt;
  const float d_q = qpos ? d_xx / (2.0f * xx) : 0.0f;
  const float d_rs = (2.0f * r_) * d_q;
  const float d_p0 = (-2.0f * p0) * d_q, d_p1 = (-2.0f * p1) * d_q,
              d_p2 = (-2.0f * p2) * d_q;
  d_m0 = d_m0 + d_p0;
  d_m1 = d_m1 + d_p1;
  d_m2 = d_m2 + d_p2;
  d_d0 = d_d0 - d_p0 * tp;
  d_d1 = d_d1 - d_p1 * tp;
  d_d2 = d_d2 - d_p2 * tp;
  d_tp = d_tp - trt_dot3(d0, d1, d2, d_p0, d_p1, d_p2);
  d_m0 = d_m0 + d0 * d_tp;
  d_m1 = d_m1 + d1 * d_tp;
  d_m2 = d_m2 + d2 * d_tp;
  d_d0 = d_d0 + m0 * d_tp;
  d_d1 = d_d1 + m1 * d_tp;
  d_d2 = d_d2 + m2 * d_tp;
  d_o0 = d_o0 - d_m0;
  d_o1 = d_o1 - d_m1;
  d_o2 = d_o2 - d_m2;
  if (has_tris) {
    d_w[0] = d_wt0 + d_m0; d_w[1] = d_wt1 + d_m1; d_w[2] = d_wt2 + d_m2;
    d_w[3] = d_rt + d_rs;
  } else {
    d_w[0] = d_m0; d_w[1] = d_m1; d_w[2] = d_m2;
    d_w[3] = d_rs;
  }

  d_s[0] = d_o0; d_s[1] = d_o1; d_s[2] = d_o2;
  d_s[3] = d_d0; d_s[4] = d_d1; d_s[5] = d_d2;
  d_s[6] = d_a0; d_s[7] = d_a1; d_s[8] = d_a2;
}

// ---------------------------------------------------------------------------
// The fixed-order sum of d_table, shared by K3 (regen_bwd.cu) and K6
// (bounce.cu). No float atomics, so d_table is the same from run to run.
// A block walks its lane tiles in order, and at each step of a tile adds
// its lanes' d_winner into its own [n, 12] partial row in this order:
// within a warp the lanes of one winner (__match_any_sync) are summed by
// their lowest lane in lane order, starting from +0.0; the row entry of a
// winner then gets the warps' sums added one after the other in warp
// order, ((acc + s_w0) + s_w1) + ...; a second launch sums the blocks'
// rows in block order from +0.0 (trt_sum_parts).
// kernels/bounce_step.py table_sum_fixed_order is its plain version.
// ---------------------------------------------------------------------------

// Stage this thread's d_w in its slot of sdw (13 floats a thread: 13, not
// 12, so consecutive threads start in different banks) and sum each
// winner's lanes of the warp by the winner's lowest lane -> is this thread
// that lane (key >= 0); sum then holds the warp's sum.
__device__ __forceinline__ bool trt_warp_key_sum(float* sdw, int key,
                                                 const float* d_w,
                                                 float* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 12; ++k) sdw[threadIdx.x * 13 + k] = d_w[k];
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  __syncwarp();
  const bool leader = key >= 0 && lane == __ffs(peers) - 1;
  if (leader) {
    for (int k = 0; k < 12; ++k) sum[k] = 0.0f;
    for (unsigned mk = peers; mk; mk &= mk - 1) {
      const float* v = sdw + (warp * 32 + __ffs(mk) - 1) * 13;
      for (int k = 0; k < 12; ++k) sum[k] = sum[k] + v[k];
    }
  }
  return leader;
}

// One step where the partial row acc lies in shared memory (the shared-row
// branch, a row of up to TRT_BWD_SMEM_ROW bytes): the warps add their
// sums one warp at a time, a block barrier after each turn.
__device__ __forceinline__ void trt_row_turns(float* sdw, int key,
                                              const float* d_w, float* acc) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  float sum[12];
  const bool leader = trt_warp_key_sum(sdw, key, d_w, sum);
  for (int wp = 0; wp < n_warps; ++wp) {
    if (warp == wp && leader) {
      for (int k = 0; k < 12; ++k) {
        acc[12 * key + k] = acc[12 * key + k] + sum[k];
      }
    }
    __syncthreads();
  }
}

// The global-row branch: the block's partial row lies in global memory
// (its own row of the partials, which no other block touches), and each
// step makes one merge. Its shared scratch, laid out by trt_row_merge_at
// (trt_row_merge_bytes bytes): TRT_MERGE_BUFS buffers, each of val, 13
// floats a thread (the staged d_winner, then each warp's sums at the slots
// of its keys), key and cnt (each warp's keys, compacted to its first
// slots, and their count); then a tally of 4 and the bitmap of the rows
// the block has touched. The steps take the buffers in turn, so one
// barrier a step suffices: a thread writes a buffer again two steps
// later, past the barrier of the step between, which every thread reaches
// only once it has read that buffer.
#define TRT_MERGE_BUFS 2

struct TrtRowMerge {
  float* val;
  int* key;
  int* cnt;
  unsigned* tally;
  unsigned* bits;
};

__host__ __device__ inline size_t trt_row_merge_bytes(int threads, int n) {
  return ((size_t)TRT_MERGE_BUFS * (14 * threads + threads / 32) + 4 +
          (n + 31) / 32) * 4;
}

__device__ __forceinline__ TrtRowMerge trt_row_merge_at(float* smem,
                                                        int threads) {
  TrtRowMerge s;
  s.val = smem;
  s.key = reinterpret_cast<int*>(smem + TRT_MERGE_BUFS * 13 * threads);
  s.cnt = s.key + TRT_MERGE_BUFS * threads;
  s.tally = reinterpret_cast<unsigned*>(s.cnt + TRT_MERGE_BUFS * threads /
                                        32);
  s.bits = s.tally + 4;
  return s;
}

// Clear the bitmap; a block barrier must follow before the first merge.
__device__ __forceinline__ void trt_row_merge_begin(const TrtRowMerge& s,
                                                    int n) {
  for (int k = threadIdx.x; k < (n + 31) / 32; k += blockDim.x) {
    s.bits[k] = 0u;
  }
}

// The slot of key among a warp's m compacted keys (a warp holds a key at
// most once), -1 if it has none.
__device__ __forceinline__ int trt_key_slot(const int* keys, int m,
                                            int key) {
  int at = -1;
  for (int j = 0; j < m; ++j) at = keys[j] == key ? j : at;
  return at;
}

// One step of the global-row branch, reached by every thread of the block.
// The warps stage their keyed sums; after one barrier the thread of a
// key's lowest warp reads the row entry (or starts from +0.0 where the
// block has not touched it, which the bitmap says: the partials are never
// cleared), adds that warp's sum and the later warps' sums for the key in
// warp order, and writes it back: one read-add-write a key, all in
// parallel (a key has one such thread a step), the same f32 sums as the
// turns of trt_row_turns. c counts: c[0] steps merged (its parity picks
// the step's buffer), c[1] warp sums staged, c[2] row entries written,
// c[3] of them first touches.
__device__ __forceinline__ void trt_row_merge(const TrtRowMerge& s, int key,
                                              const float* d_w, float* row,
                                              unsigned* c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned buf = c[0] % TRT_MERGE_BUFS;
  float* val = s.val + buf * 13 * blockDim.x;
  int* keys = s.key + buf * blockDim.x;
  int* cnt = s.cnt + buf * n_warps;
  float sum[12];
  const bool leader = trt_warp_key_sum(val, key, d_w, sum);
  const unsigned leaders = __ballot_sync(0xffffffffu, leader);
  __syncwarp();   // the warp's staged d_winner is read: its slots are free
  if (leader) {
    const int slot = warp * 32 + __popc(leaders & ((1u << lane) - 1u));
    keys[slot] = key;
    for (int k = 0; k < 12; ++k) val[slot * 13 + k] = sum[k];
  }
  if (lane == 0) cnt[warp] = __popc(leaders);
  c[0] += 1u;
  c[1] += leader ? 1u : 0u;
  __syncthreads();
  if (lane < cnt[warp]) {
    const int mine = keys[warp * 32 + lane];
    bool lowest = true;
    for (int w = 0; w < warp && lowest; ++w) {
      lowest = trt_key_slot(keys + w * 32, cnt[w], mine) < 0;
    }
    if (lowest) {
      const unsigned bit = 1u << (mine & 31);
      const bool seen = (atomicOr(s.bits + (mine >> 5), bit) & bit) != 0u;
      float4* dst = reinterpret_cast<float4*>(row + 12 * (size_t)mine);
      float v[12];
      if (seen) {
        for (int q = 0; q < 3; ++q) {
          const float4 x = dst[q];
          v[4 * q] = x.x; v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
        }
      } else {
        for (int k = 0; k < 12; ++k) v[k] = 0.0f;
      }
      const float* a = val + (warp * 32 + lane) * 13;
      for (int k = 0; k < 12; ++k) v[k] = v[k] + a[k];
      for (int w = warp + 1; w < n_warps; ++w) {
        const int j = trt_key_slot(keys + w * 32, cnt[w], mine);
        if (j >= 0) {
          const float* b = val + (w * 32 + j) * 13;
          for (int k = 0; k < 12; ++k) v[k] = v[k] + b[k];
        }
      }
      for (int q = 0; q < 3; ++q) {
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                             v[4 * q + 3]);
      }
      c[2] += 1u;
      c[3] += seen ? 0u : 1u;
    }
  }
  if (TRT_MERGE_BUFS == 1) __syncthreads();
}

// After the block's last step, reached by every thread: the bitmap to the
// block's row of touched ([gridDim.x, ceil(n / 32)] u32) and, where stats
// is not nullptr (u64 [5], added to), the counts of trt_row_merge summed
// over the block: 0 steps merged (the block's own, once), 1 warp sums, 2
// row entries written, 3 first touches (rows the block touched), and 4
// the most rows one block touched (atomicMax).
__device__ __forceinline__ void trt_row_merge_end(
    const TrtRowMerge& s, int n, unsigned* __restrict__ touched,
    unsigned long long* stats, const unsigned* c) {
  const int words = (n + 31) / 32;
  __syncthreads();
  for (int k = threadIdx.x; k < words; k += blockDim.x) {
    touched[(size_t)blockIdx.x * words + k] = s.bits[k];
  }
  if (stats == nullptr) return;
  if (threadIdx.x < 4) s.tally[threadIdx.x] = 0u;
  __syncthreads();
  for (int q = 1; q < 4; ++q) {
    const unsigned v = __reduce_add_sync(0xffffffffu, c[q]);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(s.tally + q, v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(stats, (unsigned long long)c[0]);
    for (int q = 1; q < 4; ++q) {
      atomicAdd(stats + q, (unsigned long long)s.tally[q]);
    }
    atomicMax(stats + 4, (unsigned long long)s.tally[3]);
  }
}

namespace {

// out[j] = the sum over k in order of part[k, j], j < m, from +0.0, over
// every part (the shared-row branch's dense partials).
__global__ void trt_sum_parts(const float* __restrict__ part, int parts,
                              int m, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
#pragma unroll 16
  for (int k = 0; k < parts; ++k) s = s + part[(size_t)k * m + j];
  out[j] = s;
}

// The global-row branch's sum: out[j] over the parts whose bit of row
// j / 12 is set in touched ([parts, words] row bitmaps of
// trt_row_merge_end), in order from +0.0; the others' entries were never
// written. Skipping them gives the same bits as adding their +0.0: a sum
// that starts at +0.0 is never -0.0 in round-to-nearest, and s + 0.0 = s
// for every other s. Block w sums the 32 rows of bitmap word w (384
// entries, a thread each), that word of every part staged in shared
// memory first (parts u32 of dynamic shared memory).
__global__ void trt_sum_parts_touched(const float* __restrict__ part,
                                      const unsigned* __restrict__ touched,
                                      int words, int parts, int m,
                                      float* __restrict__ out) {
  extern __shared__ unsigned s_bits[];
  const int w = blockIdx.x;
  for (int k = threadIdx.x; k < parts; k += blockDim.x) {
    s_bits[k] = touched[(size_t)k * words + w];
  }
  __syncthreads();
  const int j = w * 384 + threadIdx.x;
  if (j >= m) return;
  const unsigned bit = 1u << ((j / 12) & 31);
  float s = 0.0f;
  for (int k = 0; k < parts; ++k) {
    if (s_bits[k] & bit) s = s + part[(size_t)k * m + j];
  }
  out[j] = s;
}

// Launch the sum of parts partial rows of m = 12 n entries into out on
// stream: touched nullptr, trt_sum_parts; else trt_sum_parts_touched.
inline void trt_sum_parts_launch(const float* part, const unsigned* touched,
                                 int words, int parts, int m, float* out,
                                 cudaStream_t stream) {
  if (m == 0) return;
  if (touched == nullptr) {
    trt_sum_parts<<<(m + 63) / 64, 64, 0, stream>>>(part, parts, m, out);
  } else {
    trt_sum_parts_touched<<<words, 384, (size_t)parts * 4, stream>>>(
        part, touched, words, parts, m, out);
  }
}

}  // namespace
