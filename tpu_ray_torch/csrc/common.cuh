// Device functions shared by the search, regen and bounce kernels.
//
// Built with -fmad=false: every a*b+c below rounds twice, exactly as the
// plain PyTorch versions (tpu_ray_torch/ops) compute it one op at a time,
// so kernel and plain version agree bit for bit. Each expression keeps the
// plain version's association order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRT_F32_EPS 1e-4f
#define TRT_F32_MAX 1e30f
// ops/intersect_tri.py _DET_EPS: |det| at or below it is no hit
#define TRT_DET_EPS 1e-9f

#define TRT_MIX_SAMPLE 0x85EBCA6Bu
#define TRT_MIX_BOUNCE 0x632BE59Bu
#define TRT_MIX_SLOT 0xC2B2AE35u

// The widest sphere table a block stages in shared memory (16 B a sphere).
#define TRT_MAX_SMEM_BYTES (200 * 1024)

// Stateless PCG permutation, bit-identical to core/rng.py pcg_hash.
__device__ __forceinline__ uint32_t trt_pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t shift = (state >> 28) + 4u;
  uint32_t word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// core/rng.py draw_uniform: f32(u) * ((hi - lo) / 2^32) + lo, with the
// scale given exactly (a power of two for every range used).
__device__ __forceinline__ float trt_draw(uint32_t base, uint32_t bterm,
                                          uint32_t slot, float scale,
                                          float lo) {
  uint32_t u = trt_pcg_hash(base + bterm + slot * TRT_MIX_SLOT);
  return __uint2float_rn(u) * scale + lo;
}

// ops/vec.py safe_sqrt
__device__ __forceinline__ float trt_safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// ops/vec.py normalize_eps: v * (1/sqrt(|v|^2)), 0 when |v|^2 <= eps.
__device__ __forceinline__ void trt_normalize_eps(float& x, float& y,
                                                  float& z) {
  float lsq = x * x + y * y + z * z;
  if (lsq > TRT_F32_EPS) {
    float inv = 1.0f / sqrtf(lsq);
    x = x * inv;
    y = y * inv;
    z = z * inv;
  } else {
    x = 0.0f;
    y = 0.0f;
    z = 0.0f;
  }
}

// ops/intersect.py nearest_hit folded over spheres [k0, k1) staged in
// shared memory as (cx, cy, cz, r) into a running (best, bi). Strict <
// keeps the lowest index on ties when ranges are folded in index order.
__device__ __forceinline__ void trt_fold_spheres(
    const float4* __restrict__ sph, int k0, int k1, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best, int& bi) {
  for (int i = k0; i < k1; ++i) {
    const float4 s = sph[i];
    const float mx = s.x - ox, my = s.y - oy, mz = s.z - oz;
    const float tp = mx * dx + my * dy + mz * dz;
    const float px = mx - dx * tp, py = my - dy * tp, pz = mz - dz * tp;
    const float dsq = px * px + py * py + pz * pz;
    const float r2 = s.w * s.w;
    if (dsq < r2) {
      const float x = trt_safe_sqrt(r2 - dsq);
      const float tn = tp - x;
      const float t = tn < TRT_F32_EPS ? tp + x : tn;
      if (t > TRT_F32_EPS && t < best) {
        best = t;
        bi = i;
      }
    }
  }
}

// ops/intersect.py nearest_hit for one ray over n spheres staged in shared
// memory. A miss leaves t = 1e30, idx = 0.
__device__ __forceinline__ void trt_nearest_sphere(
    const float4* __restrict__ sph, int n, float ox, float oy, float oz,
    float dx, float dy, float dz, float& t_out, int& idx_out) {
  t_out = TRT_F32_MAX;
  idx_out = 0;
  trt_fold_spheres(sph, 0, n, ox, oy, oz, dx, dy, dz, t_out, idx_out);
}

// ops/intersect_tri.py _mt_slab for one ray and the triangle at w (v0,
// e1, e2: 9 floats): Möller-Trumbore in the plain version's op order.
// -> whether it is a hit (|det| > 1e-9, u >= 0, v >= 0, u + v <= 1,
// t > 1e-4), with its t. A triangle that fails the det or u test returns
// early; every value it does compute is the plain version's.
__device__ __forceinline__ bool trt_tri_hit(const float* w, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& t) {
  const float v0x = w[0], v0y = w[1], v0z = w[2];
  const float e1x = w[3], e1y = w[4], e1z = w[5];
  const float e2x = w[6], e2y = w[7], e2z = w[8];
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > TRT_DET_EPS)) return false;
  const float inv = 1.0f / det;
  // tvec = o - v0
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  if (!(u >= 0.0f)) return false;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return v >= 0.0f && u + v <= 1.0f && t > TRT_F32_EPS;
}

// ops/intersect_tri.py nearest_hit_tri folded over the triangles [j0, j1)
// of a [*, 9] v0|e1|e2 table into a running (best, bi), triangle j taking
// the id id0 + j. Strict < keeps the lowest id on ties when ranges are
// folded in id order (after the spheres, the rule of merge_payloads).
__device__ __forceinline__ void trt_fold_tris(
    const float* __restrict__ tri, int j0, int j1, int id0, float ox,
    float oy, float oz, float dx, float dy, float dz, float& best,
    int& bi) {
  for (int j = j0; j < j1; ++j) {
    float t;
    if (trt_tri_hit(tri + 9 * (size_t)j, ox, oy, oz, dx, dy, dz, t) &&
        t < best) {
      best = t;
      bi = id0 + j;
    }
  }
}

// Stage n spheres (center [n,3], radius [n]) into shared memory.
__device__ __forceinline__ void trt_stage_spheres(
    float4* sph, const float* __restrict__ center,
    const float* __restrict__ radius, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    sph[k] = make_float4(center[3 * k], center[3 * k + 1],
                         center[3 * k + 2], radius[k]);
  }
  __syncthreads();
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename K>
__host__ inline cudaError_t trt_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
