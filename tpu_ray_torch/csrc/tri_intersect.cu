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
// an H100 thread runs the f32 chain of common.cuh trt_tri_hit_regs, the
// plain version's op order, so the two agree bit for bit on every lane.
// Every triangle is tested: no box culls a pair, since Möller-Trumbore
// accepts a grazing hit outside its tile's inflated box, which the full
// sweep must fold.
//
// Bound on the H100: fp32 ALU. A ray-triangle test is 14, 24 or 46 flops
// by where it leaves trt_tri_hit_regs, against 36 B of triangle read from
// shared memory; the ray is 24 B in and 8 B out, so at 10,368 triangles
// the work is ~10^5 flops per 32 B of device memory. The kernels are
// built with -fmad=false (bit parity with the plain version), so no
// multiply and add fuse: the sweep can reach at most half of the bound
// priced at the 67 TFLOP/s fp32 peak, which counts an FMA as two.
//
// Design, against that bound:
// - Several rays a thread (TRT_K7_RAYS), in registers: each staged
//   triangle feeds that many independent test chains, which hide each
//   other's latency (the IEEE 1 / det and the dependent dot products),
//   and costs three broadcast float4 reads from shared memory (rows
//   padded to 12 floats) for all of them.
// - The triangle axis is split where the rays alone do not fill the card
//   (trt_tri_slices: the grid is ray blocks x triangle slices, aiming at
//   TRT_K7_WAVES waves of resident blocks), merged per ray by the 64-bit
//   (t, id) atomicMin of the sliced search K1 shares (common.cuh
//   trt_search_slices, trt_merge_hit, trt_keys_unpack). At one slice (the
//   1920x1080 wavefront fills the card alone) the block writes t and idx
//   itself, with no atomics and no second launch.
// - Tiles of TRT_K7_TILE triangles are staged between two __syncthreads:
//   with TRT_K7_RAYS rays a thread, a tile is 1,024 tests a thread
//   between barriers. The search has no early exit, so every thread
//   reaches them.
#include "common.cuh"

#define TRT_K7_THREADS 128
#define TRT_K7_RAYS 4
#define TRT_K7_BLOCK_RAYS (TRT_K7_THREADS * TRT_K7_RAYS)
#define TRT_K7_TILE 256
// the grid aims at this many waves of resident blocks
#define TRT_K7_WAVES 3
// the fewest triangles a slice holds (fewer slices past it)
#define TRT_K7_MIN_SLICE 128

namespace {

// Ray block blockIdx.x (rays blockIdx.x * TRT_K7_BLOCK_RAYS + k *
// TRT_K7_THREADS + threadIdx.x, k < TRT_K7_RAYS) against the triangles
// [blockIdx.y * slice_m, min(m, (blockIdx.y + 1) * slice_m)). SPLIT: merge
// into keys (atomicMin); else write t_out and idx_out.
template <bool SPLIT>
__global__ void __launch_bounds__(TRT_K7_THREADS)
tri_nearest_hit_kernel(const float* __restrict__ tri, int m, int slice_m,
                       const float* __restrict__ origin,
                       const float* __restrict__ direction, int r,
                       float* __restrict__ t_out, int* __restrict__ idx_out,
                       unsigned long long* __restrict__ keys) {
  __shared__ float4 tile[3 * TRT_K7_TILE];
  const int i0 = blockIdx.x * TRT_K7_BLOCK_RAYS + threadIdx.x;
  float ox[TRT_K7_RAYS], oy[TRT_K7_RAYS], oz[TRT_K7_RAYS];
  float dx[TRT_K7_RAYS], dy[TRT_K7_RAYS], dz[TRT_K7_RAYS];
  float best[TRT_K7_RAYS];
  int bi[TRT_K7_RAYS];
#pragma unroll
  for (int k = 0; k < TRT_K7_RAYS; ++k) {
    const int i = i0 + k * TRT_K7_THREADS;
    // a ray past r has d = 0: det = 0 fails every triangle at once
    ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = 0.0f;
    if (i < r) {
      ox[k] = origin[3 * (size_t)i];
      oy[k] = origin[3 * (size_t)i + 1];
      oz[k] = origin[3 * (size_t)i + 2];
      dx[k] = direction[3 * (size_t)i];
      dy[k] = direction[3 * (size_t)i + 1];
      dz[k] = direction[3 * (size_t)i + 2];
    }
    best[k] = TRT_F32_MAX;
    bi[k] = 0;
  }
  const int j_begin = blockIdx.y * slice_m;
  const int j_end = min(m, j_begin + slice_m);
  for (int j0 = j_begin; j0 < j_end; j0 += TRT_K7_TILE) {
    const int cnt = min(TRT_K7_TILE, j_end - j0);
    __syncthreads();     // every thread is done with the previous tile
    for (int q = threadIdx.x; q < cnt; q += TRT_K7_THREADS) {
      const float* w = tri + 9 * (size_t)(j0 + q);
      tile[3 * q] = make_float4(w[0], w[1], w[2], w[3]);
      tile[3 * q + 1] = make_float4(w[4], w[5], w[6], w[7]);
      tile[3 * q + 2] = make_float4(w[8], 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 a = tile[3 * j], b = tile[3 * j + 1], c = tile[3 * j + 2];
#pragma unroll
      for (int k = 0; k < TRT_K7_RAYS; ++k) {
        float t;
        if (trt_tri_hit_regs(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x,
                             ox[k], oy[k], oz[k], dx[k], dy[k], dz[k], t) &&
            t < best[k]) {
          best[k] = t;
          bi[k] = j0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TRT_K7_RAYS; ++k) {
    const int i = i0 + k * TRT_K7_THREADS;
    if (i >= r) continue;
    if (SPLIT) {
      if (best[k] < TRT_F32_MAX) trt_merge_hit(keys + i, best[k], bi[k]);
    } else {
      t_out[i] = best[k];
      idx_out[i] = bi[k];
    }
  }
}

}  // namespace

// The resident blocks of tri_nearest_hit_kernel a wave holds on each
// device (trt_wave_of).
static int trt_k7_wave[TRT_MAX_DEVICES];

// The triangle slices of a launch of r rays over m triangles on the
// current device -> at least 1; 1 where the ray blocks alone make
// TRT_K7_WAVES waves of resident blocks, else enough slices for that many
// blocks, each slice at least TRT_K7_MIN_SLICE triangles. A negative
// return is a CUDA error.
extern "C" int trt_tri_slices(int r, int m) {
  const int wave = trt_wave_of(tri_nearest_hit_kernel<true>, TRT_K7_THREADS,
                               trt_k7_wave);
  if (wave < 0) return wave;
  return trt_search_slices(r, m, TRT_K7_BLOCK_RAYS, TRT_K7_MIN_SLICE,
                           TRT_K7_WAVES, wave);
}

// tri [m, 9] v0|e1|e2; origin, direction [r, 3]; slices >= 1 (the
// triangle axis split in that many ascending slices); keys [r] u64
// scratch, needed when slices > 1; t_out [r] f32, idx_out [r] i32.
extern "C" int trt_tri_nearest_hit(const float* tri, int m,
                                   const float* origin,
                                   const float* direction, int r, int slices,
                                   unsigned long long* keys, float* t_out,
                                   int* idx_out, cudaStream_t stream) {
  if (m < 0 || r < 0 || slices < 1 || slices > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (r == 0) return 0;    // an empty keys tensor has no pointer
  if (slices > 1 && keys == nullptr) return (int)cudaErrorInvalidValue;
  const int slice_m = (int)(((long long)m + slices - 1) / slices);
  const dim3 grid((r + TRT_K7_BLOCK_RAYS - 1) / TRT_K7_BLOCK_RAYS, slices);
  if (slices == 1) {
    tri_nearest_hit_kernel<false><<<grid, TRT_K7_THREADS, 0, stream>>>(
        tri, m, slice_m, origin, direction, r, t_out, idx_out, nullptr);
    return (int)cudaGetLastError();
  }
  cudaError_t err = trt_keys_clear(keys, r, stream);
  if (err != cudaSuccess) return (int)err;
  tri_nearest_hit_kernel<true><<<grid, TRT_K7_THREADS, 0, stream>>>(
      tri, m, slice_m, origin, direction, r, nullptr, nullptr, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)trt_keys_unpack<7>(keys, r, t_out, idx_out, stream);
}
