// K7: nearest triangle hit per ray.
//
// Replaces tpu_ray/kernels/tri_intersect.py::nearest_hit_tri_pallas
// (_kernel_packed / _kernel_exact, pallas_call at :389). Contract:
// ops/intersect_tri.py nearest_hit_tri, plain f32 Möller-Trumbore with no
// backface culling: |det| > 1e-9, u >= 0, v >= 0, u + v <= 1, t > 1e-4;
// degenerate padding never hits; the lowest index wins a tie; a miss
// gives t = 1e30 and idx = 0. The TPU kernel's bf16x3 split bilinear
// tables (tri_search_tables: det, t*det, u*det and v*det as MXU products)
// and packed (t|idx) argmin are TPU mechanism and are not carried over:
// an H100 thread runs the f32 chain of common.cuh trt_tri_hit, the plain
// version's op order, so the two agree bit for bit.
//
// Bound on the H100: fp32 ALU. A ray-triangle test is ~45 flops when it
// passes the det and u tests (fewer when it does not) against 36 B of
// triangle read from shared memory; the ray is 24 B in and 8 B out, so at
// 10,368 triangles the work is ~10^5 flops per 32 B of device memory.
//
// Design: one thread per ray. The triangle table (36 B a triangle, 373 KB
// for trimesh) does not fit shared memory, so each block stages it in
// tiles of TRT_TRI_TILE triangles (36 KB) between two __syncthreads (the
// search has no early exit, so every thread reaches them), and every
// thread sweeps the staged tile with a broadcast read. A thread owns its
// ray's argmin, so no cross-thread reduction is needed; the tiles are
// folded in id order with strict <, so the lowest index wins a tie.
#include "common.cuh"

#define TRT_TRI_TILE 1024

namespace {

__global__ void tri_nearest_hit_kernel(const float* __restrict__ tri, int m,
                                       const float* __restrict__ origin,
                                       const float* __restrict__ direction,
                                       int r, float* __restrict__ t_out,
                                       int* __restrict__ idx_out) {
  __shared__ float tile[TRT_TRI_TILE * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (in) {
    ox = origin[3 * i]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = direction[3 * i]; dy = direction[3 * i + 1];
    dz = direction[3 * i + 2];
  }
  float best = TRT_F32_MAX;
  int bi = 0;
  for (int j0 = 0; j0 < m; j0 += TRT_TRI_TILE) {
    const int cnt = min(TRT_TRI_TILE, m - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < 9 * cnt; k += blockDim.x) {
      tile[k] = tri[(size_t)9 * j0 + k];
    }
    __syncthreads();
    if (in) trt_fold_tris(tile, 0, cnt, j0, ox, oy, oz, dx, dy, dz, best, bi);
  }
  if (in) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

}  // namespace

// tri [m, 9] v0|e1|e2; origin, direction [r, 3]; t_out [r] f32, idx_out
// [r] i32.
extern "C" int trt_tri_nearest_hit(const float* tri, int m,
                                   const float* origin,
                                   const float* direction, int r,
                                   float* t_out, int* idx_out,
                                   cudaStream_t stream) {
  if (m < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  tri_nearest_hit_kernel<<<blocks, threads, 0, stream>>>(
      tri, m, origin, direction, r, t_out, idx_out);
  return (int)cudaGetLastError();
}
