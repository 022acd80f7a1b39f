// K1: nearest sphere hit per ray.
//
// Replaces tpu_ray/kernels/sphere_intersect.py::nearest_hit_pallas
// (_kernel_packed / _kernel_exact, pallas_call at :204). Contract:
// ops/intersect.py nearest_hit, the exact projection form: t > 1e-4, the
// far root when the near root is behind the origin, radius-0 padding never
// hits, the lowest index wins a tie, a miss gives t = 1e30 and idx = 0.
// The TPU kernel's bf16x6 K-stacked matmul roots and packed (t|idx) argmin
// are not carried over: an H100 thread does the f32 chain directly.
//
// Bound on the H100: fp32 ALU. Each ray-sphere pair costs ~20 flops
// (plus one sqrt on a hit) and reads 16 B of sphere from shared memory;
// the ray itself is 24 B in and 8 B out, so at 512 spheres the work is
// ~10k flops per 32 B of device memory, far above the fp32 ridge.
//
// Design: one thread per ray; each block stages the whole sphere table
// (16 B a sphere, 8 KB for 512) in shared memory once, then every thread
// sweeps it with a broadcast read (all threads read the same sphere at
// once, so there are no bank conflicts). No cross-thread reduction is
// needed because a thread owns its ray's argmin.
#include "common.cuh"

namespace {

__global__ void sphere_nearest_hit_kernel(
    const float* __restrict__ center, const float* __restrict__ radius,
    int n, const float* __restrict__ origin,
    const float* __restrict__ direction, int r, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  trt_stage_spheres(sph, center, radius, n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  float t;
  int idx;
  trt_nearest_sphere(sph, n, origin[3 * i], origin[3 * i + 1],
                     origin[3 * i + 2], direction[3 * i],
                     direction[3 * i + 1], direction[3 * i + 2], t, idx);
  t_out[i] = t;
  idx_out[i] = idx;
}

}  // namespace

extern "C" int trt_sphere_nearest_hit(const float* center,
                                      const float* radius, int n,
                                      const float* origin,
                                      const float* direction, int r,
                                      float* t_out, int* idx_out,
                                      cudaStream_t stream) {
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(sphere_nearest_hit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  sphere_nearest_hit_kernel<<<blocks, threads, smem, stream>>>(
      center, radius, n, origin, direction, r, t_out, idx_out);
  return (int)cudaGetLastError();
}
