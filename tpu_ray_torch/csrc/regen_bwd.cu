// K3: the regen backward, the reverse of a whole recorded trace in one
// launch.
//
// Replaces tpu_ray/kernels/regen.py::regen_seg_bwd (_regen_seg_kernel,
// pallas_call at :967; body :493-719). The plain version is
// kernels/regen.py regen_bwd_plain (shading transpose:
// kernels/bounce_step.py shade_vjp_plain); this file repeats its f32 op
// sequence, branch-free like it, so d_state agrees exactly (see common.cuh
// on -fmad=false).
//
// Inputs: the records of K2's recording mode (regen.cu): rec [steps, r]
// i16 winner ids, chk [ceil(steps/seg), 24, r] checkpoints, t_end [r];
// the cotangent of the final state in dst [24, r] (rows 0-11 and 16-18
// read). Outputs: dst becomes the cotangent of the state before step 0
// (rows 12-15 and 19-23 zero); d_table [P,12] and d_cam [12] are ADDED to
// (the caller zeroes them).
//
// Design: one thread per lane, for all of its segments, last to first.
// For each segment it loads the checkpoint, replays the segment's alive
// steps without search through trt_step_tail (regen_step.cuh, the
// forward's own code, so the replayed states are the forward's bit for
// bit), stashing the 12 rows the transpose reads (origin, direction,
// attenuation, rng base, sample, bounce: 48 B a step, in local memory),
// then sweeps back through the hand transpose of the step. The cotangent
// stays in registers across segments, so the TPU kernel's per-segment
// launch and HBM round trip of d_state are gone. The [P,12] table sits in
// shared memory for the replay; d_table accumulates in a shared [P,12]
// block by shared-memory atomics and is added to global memory once per
// block (nonzero entries only); the 12 camera-row cotangents accumulate
// per lane in registers, then by shared and global atomics. The order of
// the atomics varies, so d_table and d_cam vary from run to run in the
// last bits.
//
// Bound on the H100: fp32 ALU (replay ~200 flops and transpose ~500 flops
// a lane-step, no search), against 2 B of record, 48 B of stash written
// and read, and 96 B of checkpoint every seg steps.
#include "regen_step.cuh"

#define TRT_SEG_MAX 64
#define TRT_STASH 12

namespace {

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// bounce_step.py nrm3_fwd: normalize_eps keeping inv and ok
__device__ __forceinline__ void nrm3_fwd(float x, float y, float z, float& ox,
                                         float& oy, float& oz, float& inv,
                                         bool& ok) {
  const float lsq = dot3(x, y, z, x, y, z);
  ok = lsq > TRT_F32_EPS;
  inv = 1.0f / sqrtf(ok ? lsq : 1.0f);
  ox = ok ? x * inv : 0.0f;
  oy = ok ? y * inv : 0.0f;
  oz = ok ? z * inv : 0.0f;
}

// bounce_step.py nrm3_bwd: d_x = where(ok, (g - y (y.g)) inv, 0)
__device__ __forceinline__ void nrm3_bwd(float yx, float yy, float yz,
                                         float inv, bool ok, float gx,
                                         float gy, float gz, float& dx,
                                         float& dy, float& dz) {
  const float s = dot3(yx, yy, yz, gx, gy, gz);
  dx = ok ? (gx - yx * s) * inv : 0.0f;
  dy = ok ? (gy - yy * s) * inv : 0.0f;
  dz = ok ? (gz - yz * s) * inv : 0.0f;
}

__device__ __forceinline__ float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// bounce_step.py shade_vjp_plain for one lane. s: the stashed pre-step
// rows (o 0-2, d 3-5, a 6-8); w: the winner's table row (row 0 on a miss,
// as the plain version gathers; every use is masked); g: cotangent rows
// 0-11. -> d_s rows 0-8 (rows 9-11 are g's) and d_w [12].
__device__ void shade_vjp(const float* s, const float* w, bool live,
                          bool sky, float rd0, float rd1, float rd2,
                          float rrefl, bool use_sky, const float* g,
                          float* d_s, float* d_w) {
  const float o0 = s[0], o1 = s[1], o2 = s[2];
  const float d0 = s[3], d1 = s[4], d2 = s[5];
  const float a0 = s[6], a1 = s[7], a2 = s[8];
  const float r_ = w[3];
  const float al0 = w[4], al1 = w[5], al2 = w[6];
  const float em0 = w[7], em1 = w[8], em2 = w[9];
  const float spec = w[10], ior = w[11];

  // ---- forward recompute, in shade_plain's op order ----
  const float m0 = w[0] - o0, m1 = w[1] - o1, m2 = w[2] - o2;
  const float tp = dot3(m0, m1, m2, d0, d1, d2);
  const float p0 = m0 - d0 * tp, p1 = m1 - d1 * tp, p2 = m2 - d2 * tp;
  const float dsq = dot3(p0, p1, p2, p0, p1, p2);
  const float xx = trt_safe_sqrt(r_ * r_ - dsq);
  const float tn = tp - xx;
  const bool inside = tn < TRT_F32_EPS;
  const float tt = inside ? tp + xx : tn;
  const bool qpos = xx > 0.0f;
  float nx, ny, nz, n_inv;
  bool n_ok;
  nrm3_fwd(d0 * tt - m0, d1 * tt - m1, d2 * tt - m2, nx, ny, nz, n_inv, n_ok);
  const float dn = dot3(d0, d1, d2, nx, ny, nz);
  const float dn2 = 2.0f * dn;
  const float pu0 = d0 - dn2 * nx, pu1 = d1 - dn2 * ny, pu2 = d2 - dn2 * nz;
  const float sgn = inside ? -1.0f : 1.0f;
  const float t20 = inside ? -nx : nx, t21 = inside ? -ny : ny,
              t22 = inside ? -nz : nz;
  float ru0, ru1, ru2, ru_inv;
  bool ru_ok;
  nrm3_fwd(rd0, rd1, rd2, ru0, ru1, ru2, ru_inv, ru_ok);
  const float rb0 = t20 + ru0, rb1 = t21 + ru1, rb2 = t22 + ru2;
  const float om = 1.0f - spec;
  float ddx, ddy, ddz, dd_inv;
  bool dd_ok;
  nrm3_fwd(om * rb0 + spec * pu0, om * rb1 + spec * pu1,
           om * rb2 + spec * pu2, ddx, ddy, ddz, dd_inv, dd_ok);
  const bool is_diel = ior != 0.0f;
  const float ior_safe = is_diel ? ior : 1.0f;
  const float ri = inside ? ior_safe : 1.0f / ior_safe;
  const float uu = dot3(-d0, -d1, -d2, t20, t21, t22);
  const float cos_t = fminf(uu, 1.0f);
  const float sin_t = trt_safe_sqrt(1.0f - cos_t * cos_t);
  const float pe0 = ri * (d0 + cos_t * t20);
  const float pe1 = ri * (d1 + cos_t * t21);
  const float pe2 = ri * (d2 + cos_t * t22);
  const float wv = 1.0f - dot3(pe0, pe1, pe2, pe0, pe1, pe2);
  const float sq = trt_safe_sqrt(fabsf(wv));
  const bool zpos = sq > 0.0f;
  const float par = -sq;
  float rfx, rfy, rfz, rf_inv;
  bool rf_ok;
  nrm3_fwd(pe0 + par * t20, pe1 + par * t21, pe2 + par * t22, rfx, rfy, rfz,
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
  nrm3_bwd(rfx, rfy, rfz, rf_inv, rf_ok, g_rf0, g_rf1, g_rf2, d_pe0, d_pe1,
           d_pe2);
  const float d_par = dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2);
  float d_t20 = par * d_pe0, d_t21 = par * d_pe1, d_t22 = par * d_pe2;
  const float d_z = zpos ? (-d_par) / (2.0f * sq) : 0.0f;
  const float d_psq = (-sign_f(wv)) * d_z;
  d_pe0 = d_pe0 + (2.0f * pe0) * d_psq;
  d_pe1 = d_pe1 + (2.0f * pe1) * d_psq;
  d_pe2 = d_pe2 + (2.0f * pe2) * d_psq;
  const float d_ri = dot3(d0 + cos_t * t20, d1 + cos_t * t21,
                          d2 + cos_t * t22, d_pe0, d_pe1, d_pe2);
  d_d0 = d_d0 + ri * d_pe0;
  d_d1 = d_d1 + ri * d_pe1;
  d_d2 = d_d2 + ri * d_pe2;
  const float d_cos = ri * dot3(t20, t21, t22, d_pe0, d_pe1, d_pe2);
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
  nrm3_bwd(ddx, ddy, ddz, dd_inv, dd_ok, g_dd0, g_dd1, g_dd2, d_mx0, d_mx1,
           d_mx2);
  d_w[10] = dot3(pu0 - rb0, pu1 - rb1, pu2 - rb2, d_mx0, d_mx1, d_mx2);
  d_t20 = d_t20 + om * d_mx0;
  d_t21 = d_t21 + om * d_mx1;
  d_t22 = d_t22 + om * d_mx2;
  d_pu0 = d_pu0 + spec * d_mx0;
  d_pu1 = d_pu1 + spec * d_mx1;
  d_pu2 = d_pu2 + spec * d_mx2;
  d_d0 = d_d0 + d_pu0;
  d_d1 = d_d1 + d_pu1;
  d_d2 = d_d2 + d_pu2;
  const float d_dn = -2.0f * dot3(nx, ny, nz, d_pu0, d_pu1, d_pu2);
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
  nrm3_bwd(nx, ny, nz, n_inv, n_ok, d_nx, d_ny, d_nz, d_nr0, d_nr1, d_nr2);

  d_o0 = d_o0 + g_no0;
  d_o1 = d_o1 + g_no1;
  d_o2 = d_o2 + g_no2;
  d_d0 = d_d0 + g_no0 * tt;
  d_d1 = d_d1 + g_no1 * tt;
  d_d2 = d_d2 + g_no2 * tt;
  float d_tt = dot3(d0, d1, d2, g_no0, g_no1, g_no2);
  d_d0 = d_d0 + d_nr0 * tt;
  d_d1 = d_d1 + d_nr1 * tt;
  d_d2 = d_d2 + d_nr2 * tt;
  d_tt = d_tt + dot3(d0, d1, d2, d_nr0, d_nr1, d_nr2);
  float d_m0 = -d_nr0, d_m1 = -d_nr1, d_m2 = -d_nr2;
  float d_tp = d_tt;
  const float d_xx = inside ? d_tt : -d_tt;
  const float d_q = qpos ? d_xx / (2.0f * xx) : 0.0f;
  d_w[3] = (2.0f * r_) * d_q;
  const float d_p0 = (-2.0f * p0) * d_q, d_p1 = (-2.0f * p1) * d_q,
              d_p2 = (-2.0f * p2) * d_q;
  d_m0 = d_m0 + d_p0;
  d_m1 = d_m1 + d_p1;
  d_m2 = d_m2 + d_p2;
  d_d0 = d_d0 - d_p0 * tp;
  d_d1 = d_d1 - d_p1 * tp;
  d_d2 = d_d2 - d_p2 * tp;
  d_tp = d_tp - dot3(d0, d1, d2, d_p0, d_p1, d_p2);
  d_m0 = d_m0 + d0 * d_tp;
  d_m1 = d_m1 + d1 * d_tp;
  d_m2 = d_m2 + d2 * d_tp;
  d_d0 = d_d0 + m0 * d_tp;
  d_d1 = d_d1 + m1 * d_tp;
  d_d2 = d_d2 + m2 * d_tp;
  d_o0 = d_o0 - d_m0;
  d_o1 = d_o1 - d_m1;
  d_o2 = d_o2 - d_m2;
  d_w[0] = d_m0; d_w[1] = d_m1; d_w[2] = d_m2;

  d_s[0] = d_o0; d_s[1] = d_o1; d_s[2] = d_o2;
  d_s[3] = d_d0; d_s[4] = d_d1; d_s[5] = d_d2;
  d_s[6] = d_a0; d_s[7] = d_a1; d_s[8] = d_a2;
}

__global__ void regen_bwd_kernel(float* __restrict__ dst, int r,
                                 const float* __restrict__ cam13,
                                 const float* __restrict__ table_g, int n,
                                 const int16_t* __restrict__ rec,
                                 const float* __restrict__ chk,
                                 const int* __restrict__ t_end, int steps,
                                 int seg, TrtRegenParams p,
                                 float* __restrict__ d_table,
                                 float* __restrict__ d_cam_g) {
  extern __shared__ float smem[];
  float* table = smem;             // [n, 12]
  float* dtab = smem + 12 * n;     // [n, 12]
  float* dcam_s = smem + 24 * n;   // [12]
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) {
    table[k] = table_g[k];
    dtab[k] = 0.0f;
  }
  if (threadIdx.x < 12) dcam_s[threadIdx.x] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r) {
    const TrtCam c = trt_load_cam(cam13);
    float g[12], g_tot[3], dcam[12];
    for (int k = 0; k < 12; ++k) {
      g[k] = dst[(size_t)k * r + i];
      dcam[k] = 0.0f;
    }
    for (int k = 0; k < 3; ++k) g_tot[k] = dst[(size_t)(16 + k) * r + i];
    const int te = min(t_end[i], steps);
    float stash[TRT_SEG_MAX * TRT_STASH];
    const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
    const float s_01 = 2.3283064365386963e-10f;   // 2^-32

    for (int s = te > 0 ? (te - 1) / seg : -1; s >= 0; --s) {
      const int t0 = s * seg;
      const int t1 = min(t0 + seg, te);
      TrtLane L = trt_load_lane(chk + (size_t)s * 24 * r, r, i);
      // replay the segment's alive steps, stashing the pre-step rows
      for (int t = t0; t < t1; ++t) {
        float* q = stash + (t - t0) * TRT_STASH;
        q[0] = L.ox; q[1] = L.oy; q[2] = L.oz;
        q[3] = L.dx; q[4] = L.dy; q[5] = L.dz;
        q[6] = L.ar; q[7] = L.ag; q[8] = L.ab;
        q[9] = __uint_as_float(L.base); q[10] = L.s_i; q[11] = L.b_i;
        trt_step_tail(L, c, table, rec[(size_t)t * r + i], p);
      }
      // sweep back through the step transposes
      for (int t = t1 - 1; t >= t0; --t) {
        const float* q = stash + (t - t0) * TRT_STASH;
        const int idx = rec[(size_t)t * r + i];
        const bool live = idx >= 0;
        const uint32_t base = __float_as_uint(q[9]);
        const float s_i = q[10], b_i = q[11];
        const float b_next = b_i + 1.0f;
        const bool finished = !(live && b_next < (float)p.max_bounces);
        const float s_next = s_i + (finished ? 1.0f : 0.0f);
        const bool has_more = finished && s_next < c.s_end;

        float g16[12];
        for (int k = 0; k < 9; ++k) g16[k] = has_more ? 0.0f : g[k];
        for (int k = 0; k < 3; ++k) g16[9 + k] = finished ? g_tot[k] : g[9 + k];
        const uint32_t bterm = (uint32_t)b_i * TRT_MIX_BOUNCE;
        const float rd0 = trt_draw(base, bterm, 0u, s_pm1, -1.0f);
        const float rd1 = trt_draw(base, bterm, 1u, s_pm1, -1.0f);
        const float rd2 = trt_draw(base, bterm, 2u, s_pm1, -1.0f);
        const float rrefl = trt_draw(base, bterm, 3u, s_01, 0.0f);
        const float* w = table + 12 * (live ? idx : 0);
        float d_s[9], d_w[12];
        shade_vjp(q, w, live, !live, rd0, rd1, rd2, rrefl, p.use_sky != 0,
                  g16, d_s, d_w);

        // the regenerated direction d3 = normalize_eps(fc + fx cam_x +
        // fy cam_y - pos): its camera cotangent
        const uint32_t nbase =
            trt_pcg_hash(L.h1 + (uint32_t)(int)s_next * TRT_MIX_SAMPLE);
        float fx, fy, rx, ry, rz, nx, ny, nz, inv, drx, dry, drz;
        bool ok;
        trt_film_offsets(L.ax, L.ay, nbase, p, fx, fy);
        trt_film_vec(c, fx, fy, rx, ry, rz);
        nrm3_fwd(rx, ry, rz, nx, ny, nz, inv, ok);
        nrm3_bwd(nx, ny, nz, inv, ok, has_more ? g[3] : 0.0f,
                 has_more ? g[4] : 0.0f, has_more ? g[5] : 0.0f, drx, dry,
                 drz);
        const float dr[3] = {drx, dry, drz};
        for (int k = 0; k < 3; ++k) {
          dcam[k] = dcam[k] + ((has_more ? g[k] : 0.0f) - dr[k]);
          dcam[3 + k] = dcam[3 + k] + dr[k];
          dcam[6 + k] = dcam[6 + k] + fx * dr[k];
          dcam[9 + k] = dcam[9 + k] + fy * dr[k];
        }
        if (live) {
          for (int k = 0; k < 12; ++k) atomicAdd(&dtab[12 * idx + k], d_w[k]);
        }
        for (int k = 0; k < 9; ++k) g[k] = d_s[k];
        for (int k = 0; k < 3; ++k) g[9 + k] = g16[9 + k];
      }
    }
    for (int k = 0; k < 24; ++k) {
      float v = 0.0f;
      if (k < 12) v = g[k];
      else if (k >= 16 && k < 19) v = g_tot[k - 16];
      dst[(size_t)k * r + i] = v;
    }
    for (int k = 0; k < 12; ++k) atomicAdd(&dcam_s[k], dcam[k]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) {
    if (dtab[k] != 0.0f) atomicAdd(&d_table[k], dtab[k]);
  }
  if (threadIdx.x < 12) atomicAdd(&d_cam_g[threadIdx.x], dcam_s[threadIdx.x]);
}

}  // namespace

extern "C" int trt_regen_bwd(float* dstate, int r, const float* cam13,
                             const float* table, int n, const int16_t* rec,
                             const float* chk, const int* t_end, int steps,
                             int seg, int use_sky, int max_bounces, int width,
                             int height, float film_w, float film_h,
                             float* d_table, float* d_cam,
                             cudaStream_t stream) {
  const size_t smem = ((size_t)24 * n + 12) * sizeof(float);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (seg < 1 || seg > TRT_SEG_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h};
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  regen_bwd_kernel<<<blocks, threads, smem, stream>>>(
      dstate, r, cam13, table, n, rec, chk, t_end, steps, seg, p, d_table,
      d_cam);
  return (int)cudaGetLastError();
}
