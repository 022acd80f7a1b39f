// Device functions shared by the sphere-search and regen kernels.
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

// ops/intersect.py nearest_hit for one ray over n spheres staged in shared
// memory as (cx, cy, cz, r). Strict < keeps the lowest index on ties; a
// miss leaves t = 1e30, idx = 0.
__device__ __forceinline__ void trt_nearest_sphere(
    const float4* __restrict__ sph, int n, float ox, float oy, float oz,
    float dx, float dy, float dz, float& t_out, int& idx_out) {
  float best = TRT_F32_MAX;
  int bi = 0;
  for (int i = 0; i < n; ++i) {
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
  t_out = best;
  idx_out = bi;
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
