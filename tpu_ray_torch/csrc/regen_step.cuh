// The regen step after the search, shared by K2 (regen.cu: forward and
// recording) and K3 (regen_bwd.cu: the backward's replay), so the replay
// repeats the forward bit for bit by construction (the JAX package shares
// _step_tail the same way, tpu_ray/kernels/regen.py:167-224).
//
// The plain version is kernels/regen.py step_tail_plain (shading by
// kernels/bounce_step.py shade_plain); this file repeats its f32 op
// sequence (see common.cuh on -fmad=false).
#pragma once

#include "common.cuh"

struct TrtCam {
  float px, py, pz, fcx, fcy, fcz, xx, xy, xz, yx, yy, yz, s_end;
};

__device__ __forceinline__ TrtCam trt_load_cam(const float* cam13) {
  TrtCam c;
  c.px = cam13[0]; c.py = cam13[1]; c.pz = cam13[2];
  c.fcx = cam13[3]; c.fcy = cam13[4]; c.fcz = cam13[5];
  c.xx = cam13[6]; c.xy = cam13[7]; c.xz = cam13[8];
  c.yx = cam13[9]; c.yy = cam13[10]; c.yz = cam13[11];
  c.s_end = cam13[12];
  return c;
}

struct TrtRegenParams {
  int use_sky, max_bounces;
  float width, height, film_w, film_h;
};

// One lane of the [24, R] state (kernels/regen.py module docstring).
struct TrtLane {
  float ox, oy, oz, dx, dy, dz, ar, ag, ab, cr, cg, cb;
  float alive;
  uint32_t base;
  float s_i, b_i, tr, tg, tb, ax, ay;
  uint32_t h1;
  float rays, row23;
};

__device__ __forceinline__ TrtLane trt_load_lane(const float* st, size_t r,
                                                 size_t i) {
#define ROW(k) st[(size_t)(k) * r + i]
  TrtLane L;
  L.ox = ROW(0); L.oy = ROW(1); L.oz = ROW(2);
  L.dx = ROW(3); L.dy = ROW(4); L.dz = ROW(5);
  L.ar = ROW(6); L.ag = ROW(7); L.ab = ROW(8);
  L.cr = ROW(9); L.cg = ROW(10); L.cb = ROW(11);
  L.alive = ROW(12);
  L.base = __float_as_uint(ROW(13));
  L.s_i = ROW(14); L.b_i = ROW(15);
  L.tr = ROW(16); L.tg = ROW(17); L.tb = ROW(18);
  L.ax = ROW(19); L.ay = ROW(20);
  L.h1 = __float_as_uint(ROW(21));
  L.rays = ROW(22); L.row23 = ROW(23);
#undef ROW
  return L;
}

__device__ __forceinline__ void trt_store_lane(float* st, size_t r, size_t i,
                                               const TrtLane& L) {
#define ROW(k) st[(size_t)(k) * r + i]
  ROW(0) = L.ox; ROW(1) = L.oy; ROW(2) = L.oz;
  ROW(3) = L.dx; ROW(4) = L.dy; ROW(5) = L.dz;
  ROW(6) = L.ar; ROW(7) = L.ag; ROW(8) = L.ab;
  ROW(9) = L.cr; ROW(10) = L.cg; ROW(11) = L.cb;
  ROW(12) = L.alive;
  ROW(13) = __uint_as_float(L.base);
  ROW(14) = L.s_i; ROW(15) = L.b_i;
  ROW(16) = L.tr; ROW(17) = L.tg; ROW(18) = L.tb;
  ROW(19) = L.ax; ROW(20) = L.ay;
  ROW(21) = __uint_as_float(L.h1);
  ROW(22) = L.rays; ROW(23) = L.row23;
#undef ROW
}

// ops/raygen.py film_offsets: the jittered film point of pixel (ax, ay)
// for stream base `base`, as offsets along cam_x and cam_y.
__device__ __forceinline__ void trt_film_offsets(
    float ax, float ay, uint32_t base, const TrtRegenParams& p, float& fx,
    float& fy) {
  const float scale = 2.3283064365386963e-10f;  // 2^-32
  const float jx = trt_draw(base, 0u, 4u, scale, -0.5f);
  const float jy = trt_draw(base, 0u, 5u, scale, -0.5f);
  const float film_x = -1.0f + ((ax + jx) * 2.0f) / p.width;
  const float film_y = -1.0f + ((ay + jy) * 2.0f) / p.height;
  fx = film_x * p.film_w * 0.5f;
  fy = film_y * p.film_h * 0.5f;
}

// ops/raygen.py film_rays, before normalisation: fc + fx cam_x + fy cam_y
// - position.
__device__ __forceinline__ void trt_film_vec(const TrtCam& c, float fx,
                                             float fy, float& rx, float& ry,
                                             float& rz) {
  rx = ((c.fcx + fx * c.xx) + fy * c.yx) - c.px;
  ry = ((c.fcy + fx * c.xy) + fy * c.yy) - c.py;
  rz = ((c.fcz + fx * c.xz) + fy * c.yz) - c.pz;
}

// The regen step of an alive lane after the search: idx is the winner row
// of the [P,12] table (center 0-2, radius 3, albedo 4-6, emissive 7-9,
// specular 10, ior 11), -1 on a miss. Sky / emissive / albedo, the scatter
// with draws keyed by the lane's bounce row, the flush of a finished
// sample, has_more against s_end, regeneration, and rays += 1.
__device__ __forceinline__ void trt_step_tail(TrtLane& L, const TrtCam& c,
                                              const float* table, int idx,
                                              const TrtRegenParams& p) {
  const bool live = idx >= 0;
  const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
  const float s_01 = 2.3283064365386963e-10f;   // 2^-32
  if (!live) {
    if (p.use_sky) {
      // ops/shade.py sky_color(d) * atten
      const float a = (L.dy + 1.0f) * 0.5f;
      const float oma = 1.0f - a;
      L.cr = L.cr + (oma * 1.0f + a * 0.5f) * L.ar;
      L.cg = L.cg + (oma * 1.0f + a * 0.7f) * L.ag;
      L.cb = L.cb + (oma * 1.0f + a * 1.0f) * L.ab;
    }
  } else {
    // ops/intersect.py hit_payload
    const float* w = table + 12 * (size_t)idx;
    const float mx = w[0] - L.ox, my = w[1] - L.oy, mz = w[2] - L.oz;
    const float tp = mx * L.dx + my * L.dy + mz * L.dz;
    const float qx = mx - L.dx * tp, qy = my - L.dy * tp,
                qz = mz - L.dz * tp;
    const float dsq = qx * qx + qy * qy + qz * qz;
    const float x = trt_safe_sqrt(w[3] * w[3] - dsq);
    const float tn = tp - x;
    const bool inside = tn < TRT_F32_EPS;
    const float t = inside ? tp + x : tn;
    const float ptx = L.dx * t, pty = L.dy * t, ptz = L.dz * t;
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
    const uint32_t bterm = (uint32_t)L.b_i * TRT_MIX_BOUNCE;
    float rx = trt_draw(L.base, bterm, 0u, s_pm1, -1.0f);
    float ry = trt_draw(L.base, bterm, 1u, s_pm1, -1.0f);
    float rz = trt_draw(L.base, bterm, 2u, s_pm1, -1.0f);
    const float rrefl = trt_draw(L.base, bterm, 3u, s_01, 0.0f);

    // ops/shade.py scatter_direction
    float nx = ptx - mx, ny = pty - my, nz = ptz - mz;
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

  // the sample ends when its ray dies or its bounce budget is spent
  const float b_next = L.b_i + 1.0f;
  const bool finished = !(live && b_next < (float)p.max_bounces);
  L.rays = L.rays + 1.0f;
  if (!finished) {
    L.b_i = b_next;
    L.alive = 1.0f;
    return;
  }
  L.s_i = L.s_i + 1.0f;
  L.tr = L.tr + L.cr; L.tg = L.tg + L.cg; L.tb = L.tb + L.cb;
  L.cr = 0.0f; L.cg = 0.0f; L.cb = 0.0f;
  L.b_i = 0.0f;
  if (L.s_i < c.s_end) {
    L.base = trt_pcg_hash(L.h1 + (uint32_t)(int)L.s_i * TRT_MIX_SAMPLE);
    float fx, fy;
    trt_film_offsets(L.ax, L.ay, L.base, p, fx, fy);
    L.ox = c.px; L.oy = c.py; L.oz = c.pz;
    trt_film_vec(c, fx, fy, L.dx, L.dy, L.dz);
    trt_normalize_eps(L.dx, L.dy, L.dz);
    L.ar = 1.0f; L.ag = 1.0f; L.ab = 1.0f;
    L.alive = 1.0f;
  } else {
    L.alive = 0.0f;
  }
}
