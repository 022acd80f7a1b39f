// The regen step after the search, shared by K2 (regen.cu: forward and
// recording) and K3 (regen_bwd.cu: the backward's replay), so the replay
// repeats the forward bit for bit by construction (the JAX package shares
// _step_tail the same way, tpu_ray/kernels/regen.py:167-224).
//
// The plain version is kernels/regen.py step_tail_plain (shading by
// kernels/bounce_step.py shade_plain, here shade.cuh trt_shade); this file
// repeats its f32 op sequence (see common.cuh on -fmad=false).
#pragma once

#include "shade.cuh"

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
  // ids at or past n_sph are triangles (n_sph = P for a sphere scene)
  int n_sph;
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
// of the [P,12] table (a triangle at or past p.n_sph), -1 on a miss. The
// shading (trt_shade) with draws
// keyed by the lane's bounce row, the flush of a finished sample, has_more
// against s_end, regeneration, and rays += 1.
__device__ __forceinline__ void trt_step_tail(TrtLane& L, const TrtCam& c,
                                              const float* table, int idx,
                                              const TrtRegenParams& p) {
  const bool live = idx >= 0;
  trt_shade(L, live ? table + 12 * (size_t)idx : nullptr,
            (uint32_t)L.b_i * TRT_MIX_BOUNCE, p.use_sky != 0,
            idx >= p.n_sph);

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
