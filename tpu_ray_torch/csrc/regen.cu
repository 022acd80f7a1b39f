// K2: persistent-wavefront regen steps over the [24, R] state, in place.
//
// Replaces tpu_ray/kernels/regen.py::regen_step: _regen_kernel (pallas_call
// at :868) and _regen_multi_kernel (steps > 1, pallas_call at :769). Each
// step is the K1 search over the shared-memory sphere table, then the
// _step_tail semantics (regen.py:167-224): sky / emissive / albedo, the
// scatter with draws keyed by the lane's own bounce row 15, the flush of a
// finished sample into rows 16-18, has_more against s_end, regeneration by
// the film math of ops/raygen.py, and rays += 1 per alive step in row 22.
// The plain version is kernels/regen.py _plain_step; this file repeats its
// f32 op sequence (see common.cuh on -fmad=false). Layout: kernels/regen.py.
//
// Bound on the H100: fp32 ALU. Each step of a lane searches every sphere
// (~20 flops a pair, 512 pairs for rtweekend) and then shades (~200 flops);
// the lane's 96 B of state is read and written once per launch, so device
// memory is idle next to the ALUs.
//
// Design: one thread owns one lane for the whole launch and keeps its state
// in registers across all `steps` steps, so the forward render is a single
// launch (steps = spp * max_bounces); the TPU kernel's per-step HBM round
// trip of the state disappears. The sphere table sits in shared memory
// (16 B a sphere) and every thread reads the same sphere at once, a
// broadcast. Materials of the one winning sphere per step come from global
// memory through L1/L2. A lane that is dead stays dead (alive is only set
// again by a live lane's regeneration), so it leaves the loop early and
// advances its bounce row by the steps it skips, as the plain version does.
// Lanes of a warp that finish early idle until the warp's slowest lane is
// done; regeneration keeps that tail short (a lane runs spp samples).
#include "common.cuh"

namespace {

struct Cam {
  float px, py, pz, fcx, fcy, fcz, xx, xy, xz, yx, yy, yz, s_end;
};

// ops/raygen.py film_rays for one lane: the unit direction through the
// jittered film point of pixel (ax, ay) for stream base `base`.
__device__ __forceinline__ void film_ray(const Cam& c, float ax, float ay,
                                         uint32_t base, float width,
                                         float height, float film_w,
                                         float film_h, float& dx, float& dy,
                                         float& dz) {
  const float scale = 2.3283064365386963e-10f;  // 2^-32
  const float jx = trt_draw(base, 0u, 4u, scale, -0.5f);
  const float jy = trt_draw(base, 0u, 5u, scale, -0.5f);
  const float film_x = -1.0f + ((ax + jx) * 2.0f) / width;
  const float film_y = -1.0f + ((ay + jy) * 2.0f) / height;
  const float fx = film_x * film_w * 0.5f;
  const float fy = film_y * film_h * 0.5f;
  dx = ((c.fcx + fx * c.xx) + fy * c.yx) - c.px;
  dy = ((c.fcy + fx * c.xy) + fy * c.yy) - c.py;
  dz = ((c.fcz + fx * c.xz) + fy * c.yz) - c.pz;
  trt_normalize_eps(dx, dy, dz);
}

__global__ void regen_steps_kernel(
    float* __restrict__ st, int r, const float* __restrict__ cam13,
    const float* __restrict__ center, const float* __restrict__ radius,
    const float* __restrict__ albedo, const float* __restrict__ emissive,
    const float* __restrict__ specular, const float* __restrict__ ior,
    int n, int steps, int use_sky, int max_bounces, int width, int height,
    float film_w, float film_h) {
  extern __shared__ float4 sph[];
  trt_stage_spheres(sph, center, radius, n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;

  Cam c;
  c.px = cam13[0]; c.py = cam13[1]; c.pz = cam13[2];
  c.fcx = cam13[3]; c.fcy = cam13[4]; c.fcz = cam13[5];
  c.xx = cam13[6]; c.xy = cam13[7]; c.xz = cam13[8];
  c.yx = cam13[9]; c.yy = cam13[10]; c.yz = cam13[11];
  c.s_end = cam13[12];

#define ROW(k) st[(size_t)(k) * r + i]
  float ox = ROW(0), oy = ROW(1), oz = ROW(2);
  float dx = ROW(3), dy = ROW(4), dz = ROW(5);
  float ar = ROW(6), ag = ROW(7), ab = ROW(8);
  float cr = ROW(9), cg = ROW(10), cb = ROW(11);
  float alive = ROW(12);
  uint32_t base = __float_as_uint(ROW(13));
  float s_i = ROW(14), b_i = ROW(15);
  float tr = ROW(16), tg = ROW(17), tb = ROW(18);
  const float ax = ROW(19), ay = ROW(20);
  const uint32_t h1 = __float_as_uint(ROW(21));
  float rays = ROW(22);

  const float fwidth = (float)width, fheight = (float)height;
  const float fmax_b = (float)max_bounces;
  const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
  const float s_01 = 2.3283064365386963e-10f;   // 2^-32

  for (int k = 0; k < steps; ++k) {
    if (!(alive > 0.5f)) {
      b_i = b_i + (float)(steps - k);
      break;
    }
    float t_hit;
    int idx;
    trt_nearest_sphere(sph, n, ox, oy, oz, dx, dy, dz, t_hit, idx);
    const bool live = t_hit < TRT_F32_MAX;

    if (!live) {
      if (use_sky) {
        // ops/shade.py sky_color(d) * atten
        const float a = (dy + 1.0f) * 0.5f;
        const float oma = 1.0f - a;
        cr = cr + (oma * 1.0f + a * 0.5f) * ar;
        cg = cg + (oma * 1.0f + a * 0.7f) * ag;
        cb = cb + (oma * 1.0f + a * 1.0f) * ab;
      }
    } else {
      // ops/intersect.py hit_payload
      const float4 s = sph[idx];
      const float mx = s.x - ox, my = s.y - oy, mz = s.z - oz;
      const float tp = mx * dx + my * dy + mz * dz;
      const float qx = mx - dx * tp, qy = my - dy * tp, qz = mz - dz * tp;
      const float dsq = qx * qx + qy * qy + qz * qz;
      const float x = trt_safe_sqrt(s.w * s.w - dsq);
      const float tn = tp - x;
      const bool inside = tn < TRT_F32_EPS;
      const float t = inside ? tp + x : tn;
      const float ptx = dx * t, pty = dy * t, ptz = dz * t;
      const float nox = ox + ptx, noy = oy + pty, noz = oz + ptz;

      cr = cr + emissive[3 * idx] * ar;
      cg = cg + emissive[3 * idx + 1] * ag;
      cb = cb + emissive[3 * idx + 2] * ab;
      ar = ar * albedo[3 * idx];
      ag = ag * albedo[3 * idx + 1];
      ab = ab * albedo[3 * idx + 2];
      const float spec = specular[idx];
      const float eta = ior[idx];

      // draws keyed by the lane's bounce row (core/rng.py slots 0-3)
      const uint32_t bterm = (uint32_t)b_i * TRT_MIX_BOUNCE;
      float rx = trt_draw(base, bterm, 0u, s_pm1, -1.0f);
      float ry = trt_draw(base, bterm, 1u, s_pm1, -1.0f);
      float rz = trt_draw(base, bterm, 2u, s_pm1, -1.0f);
      const float rrefl = trt_draw(base, bterm, 3u, s_01, 0.0f);

      // ops/shade.py scatter_direction
      float nx = ptx - mx, ny = pty - my, nz = ptz - mz;
      trt_normalize_eps(nx, ny, nz);
      const float dn2 = 2.0f * (dx * nx + dy * ny + dz * nz);
      const float purex = dx - dn2 * nx, purey = dy - dn2 * ny,
                  purez = dz - dn2 * nz;
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
        const float cdot = (-dx) * n2x + (-dy) * n2y + (-dz) * n2z;
        const float cos_t = fminf(cdot, 1.0f);
        const float sin_t = trt_safe_sqrt(1.0f - cos_t * cos_t);
        const bool cant = ri * sin_t > 1.0f;
        const float perpx = ri * (dx + cos_t * n2x);
        const float perpy = ri * (dy + cos_t * n2y);
        const float perpz = ri * (dz + cos_t * n2z);
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
      ox = nox; oy = noy; oz = noz;
      dx = ndx; dy = ndy; dz = ndz;
    }

    // the sample ends when its ray dies or its bounce budget is spent
    const float b_next = b_i + 1.0f;
    const bool finished = !(live && b_next < fmax_b);
    rays = rays + 1.0f;
    if (!finished) {
      b_i = b_next;
      alive = 1.0f;
      continue;
    }
    s_i = s_i + 1.0f;
    tr = tr + cr; tg = tg + cg; tb = tb + cb;
    cr = 0.0f; cg = 0.0f; cb = 0.0f;
    b_i = 0.0f;
    if (s_i < c.s_end) {
      base = trt_pcg_hash(h1 + (uint32_t)(int)s_i * TRT_MIX_SAMPLE);
      ox = c.px; oy = c.py; oz = c.pz;
      film_ray(c, ax, ay, base, fwidth, fheight, film_w, film_h, dx, dy, dz);
      ar = 1.0f; ag = 1.0f; ab = 1.0f;
      alive = 1.0f;
    } else {
      alive = 0.0f;
    }
  }

  ROW(0) = ox; ROW(1) = oy; ROW(2) = oz;
  ROW(3) = dx; ROW(4) = dy; ROW(5) = dz;
  ROW(6) = ar; ROW(7) = ag; ROW(8) = ab;
  ROW(9) = cr; ROW(10) = cg; ROW(11) = cb;
  ROW(12) = alive;
  ROW(13) = __uint_as_float(base);
  ROW(14) = s_i; ROW(15) = b_i;
  ROW(16) = tr; ROW(17) = tg; ROW(18) = tb;
  ROW(22) = rays;
#undef ROW
}

}  // namespace

extern "C" int trt_regen_steps(float* state, int r, const float* cam13,
                               const float* center, const float* radius,
                               const float* albedo, const float* emissive,
                               const float* specular, const float* ior,
                               int n, int steps, int use_sky,
                               int max_bounces, int width, int height,
                               float film_w, float film_h,
                               cudaStream_t stream) {
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_steps_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0 || steps <= 0) return 0;
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  regen_steps_kernel<<<blocks, threads, smem, stream>>>(
      state, r, cam13, center, radius, albedo, emissive, specular, ior, n,
      steps, use_sky, max_bounces, width, height, film_w, film_h);
  return (int)cudaGetLastError();
}
