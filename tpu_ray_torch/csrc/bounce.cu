// K4, K5, K6: the bounce kernels of the per-sample fused route
// (kernels/bounce_step.py make_fused_sample: one sample's raygen, then
// max_bounces bounces forward, and the reverse sweep in its backward).
//
// State [16, r] f32, row-major (row k at st + k * r), unpadded: 0-2
// origin, 3-5 direction, 6-8 attenuation, 9-11 colour, 12 alive (0/1),
// 13 rng stream base (u32 bits), 14-15 unused (passed through). Table
// [n, 12] f32 (ops/intersect.payload_tables of the Morton-permuted scene).
// The draws of bounce b are keyed by bterm = b * TRT_MIX_BOUNCE.
//
// K4 bounce_fwd replaces tpu_ray/kernels/bounce_step.py::bounce_fwd
// (_fwd_kernel, pallas_call at :1548): the nearest-hit search, optionally
// culled by a conservative (ray block x sphere tile) mask, then the
// shading (shade.cuh trt_shade, K2's own). -> the new state and the
// winner id (-1 on a miss or a dead lane). Plain version:
// bounce_fwd_plain.
//   Bound on the H100: fp32 ALU. Each alive lane tests every sphere of
//   every tile its block's mask row keeps (~20 flops a pair, 482 real
//   spheres on rtweekend) against 128 B of state in and out.
//   Design: one thread per lane, the block's 256 lanes are the mask's ray
//   block, so a culled tile is skipped by the whole block at once. The
//   sphere (centre, radius) table sits in shared memory (16 B a sphere)
//   and every thread reads the same sphere at once, a broadcast; the
//   winner's materials come from the [n,12] table in global memory
//   through L1. A dead lane skips the search and copies its state, so a
//   warp whose lanes are all dead costs one load and one store. The TPU
//   kernel's (ray block x tile) grid, bf16x6 search tables, packed
//   argmin and one-hot MXU gather are not carried over.
//
// K5 bounce_replay replaces bounce_replay (_replay_kernel, pallas_call at
// :1871): the same shading from a saved winner id, no search. Given K4's
// ids it gives K4's state bit for bit (same device function). Plain
// version: bounce_replay_plain.
//   Bound on the H100: bytes (128 B of state in and out and 4 B of id a
//   lane; the shading is ~100 flops). Design: one thread per lane.
//
// K6 bounce_bwd replaces bounce_bwd (_bwd_kernel, pallas_call at :1901):
// (state_in, id, d_state_out) -> d_state_in [16, r], written over
// d_state_out in place (each lane reads its own cotangent before it
// writes), and d_table [n, 12]. Plain version: bounce_bwd_plain (the
// hand transpose shade_vjp_plain, here shade.cuh trt_shade_vjp, K3's
// own). A lane that neither hits nor sees the sky passes its cotangent
// through; rows 12-15 of d_state are zero.
//   Bound on the H100: bytes (148 B a lane: state rows 0-8, 12, 13 and
//   d_out rows 0-11 read, d_state rows 0-8 and 12-15 written, the id
//   read; rows 9-11 pass through in place; the transpose is ~400 flops).
//   Design: one thread per lane; d_table must be the same from run to
//   run, so no float atomics. Launch 1 gives block k the lane tiles k,
//   k + grid, ... (a partition fixed by r alone) and sums its lanes'
//   d_winner into a shared [n,12] accumulator in a fixed order: within a
//   warp the lanes of one winner (__match_any_sync) are summed by their
//   lowest lane in lane order, then the warps add their sums one warp at
//   a time. Block k writes its accumulator to partials[k] ([parts, n, 12],
//   6.3 MB at 256 parts and 512 spheres). Launch 2 sums the partials
//   over k in order, one thread per entry. The TPU kernel carried d_table
//   across a sequential grid; Hopper's blocks run in parallel and in no
//   order.
#include "shade.cuh"

// The ray block: the threads of a K4/K5/K6 block and the row of the cull
// mask (kernels/bounce_step.py BLOCK_R).
#define TRT_BOUNCE_THREADS 256
// The most blocks of K6's first launch (its partials' leading dimension).
#define TRT_BWD_PARTS 256

namespace {

struct TrtBounceLane {
  float ox, oy, oz, dx, dy, dz, ar, ag, ab, cr, cg, cb;
  float alive;
  uint32_t base;
  float r14, r15;
};

__device__ __forceinline__ TrtBounceLane load_lane(const float* st, size_t r,
                                                   size_t i) {
#define ROW(k) st[(size_t)(k) * r + i]
  TrtBounceLane L;
  L.ox = ROW(0); L.oy = ROW(1); L.oz = ROW(2);
  L.dx = ROW(3); L.dy = ROW(4); L.dz = ROW(5);
  L.ar = ROW(6); L.ag = ROW(7); L.ab = ROW(8);
  L.cr = ROW(9); L.cg = ROW(10); L.cb = ROW(11);
  L.alive = ROW(12);
  L.base = __float_as_uint(ROW(13));
  L.r14 = ROW(14); L.r15 = ROW(15);
#undef ROW
  return L;
}

__device__ __forceinline__ void store_lane(float* st, size_t r, size_t i,
                                           const TrtBounceLane& L) {
#define ROW(k) st[(size_t)(k) * r + i]
  ROW(0) = L.ox; ROW(1) = L.oy; ROW(2) = L.oz;
  ROW(3) = L.dx; ROW(4) = L.dy; ROW(5) = L.dz;
  ROW(6) = L.ar; ROW(7) = L.ag; ROW(8) = L.ab;
  ROW(9) = L.cr; ROW(10) = L.cg; ROW(11) = L.cb;
  ROW(12) = L.alive;
  ROW(13) = __uint_as_float(L.base);
  ROW(14) = L.r14; ROW(15) = L.r15;
#undef ROW
}

// mask: nullptr, or [gridDim.x, n_tiles] i32 (nonzero = search the tile);
// tile t holds spheres [t * block_n, min((t + 1) * block_n, n)).
__global__ void bounce_fwd_kernel(const float* __restrict__ st,
                                  float* __restrict__ out, int r,
                                  const float* __restrict__ table, int n,
                                  uint32_t bterm, const int* __restrict__ mask,
                                  int n_tiles, int block_n, int use_sky,
                                  int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  TrtBounceLane L = load_lane(st, r, i);
  int idx = -1;
  if (L.alive > 0.5f) {
    float best = TRT_F32_MAX;
    int bi = 0;
    const int* row = mask ? mask + (size_t)blockIdx.x * n_tiles : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      if (row && row[t] == 0) continue;
      trt_fold_spheres(sph, t * block_n, min((t + 1) * block_n, n), L.ox,
                       L.oy, L.oz, L.dx, L.dy, L.dz, best, bi);
    }
    if (best < TRT_F32_MAX) idx = bi;
    trt_shade(L, idx >= 0 ? table + 12 * (size_t)idx : nullptr, bterm,
              use_sky != 0);
  }
  L.alive = idx >= 0 ? 1.0f : 0.0f;
  store_lane(out, r, i, L);
  idx_out[i] = idx;
}

__global__ void bounce_replay_kernel(const float* __restrict__ st,
                                     float* __restrict__ out, int r,
                                     const float* __restrict__ table,
                                     const int* __restrict__ idx_in,
                                     uint32_t bterm, int use_sky) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  TrtBounceLane L = load_lane(st, r, i);
  const int idx = idx_in[i];
  const bool live = idx >= 0;
  if (live || L.alive > 0.5f) {
    trt_shade(L, live ? table + 12 * (size_t)idx : nullptr, bterm,
              use_sky != 0);
  }
  L.alive = live ? 1.0f : 0.0f;
  store_lane(out, r, i, L);
}

// dst: d_state_out in, d_state_in out. part: [gridDim.x, n * 12].
// Dynamic shared memory: the [n, 12] accumulator, then 13 floats a thread
// of staged d_winner (13, not 12: consecutive threads then start in
// different banks).
__global__ void bounce_bwd_kernel(const float* __restrict__ st,
                                  const int* __restrict__ idx_in,
                                  const float* __restrict__ table, int n,
                                  float* __restrict__ dst, int r,
                                  uint32_t bterm, int use_sky,
                                  float* __restrict__ part) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* sdw = smem + 12 * n;
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();
  const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
  const float s_01 = 2.3283064365386963e-10f;   // 2^-32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_lane_tiles = (r + blockDim.x - 1) / blockDim.x;
  // the loop bound is the same for every thread of the block, so the
  // __syncthreads below are reached by all of them
  for (int tile = blockIdx.x; tile < n_lane_tiles; tile += gridDim.x) {
    const int i = tile * blockDim.x + threadIdx.x;
    int key = -1;
    float d_w[12];
    for (int c = 0; c < 12; ++c) d_w[c] = 0.0f;
    if (i < r) {
      float s[9], g[12], d_s[9];
      for (int k = 0; k < 9; ++k) s[k] = st[(size_t)k * r + i];
      for (int k = 0; k < 12; ++k) g[k] = dst[(size_t)k * r + i];
      const bool alive = st[(size_t)12 * r + i] > 0.5f;
      const uint32_t base = __float_as_uint(st[(size_t)13 * r + i]);
      const int idx = idx_in[i];
      const bool live = idx >= 0;
      const bool sky = alive && !live;
      if (live || sky) {
        const float rd0 = trt_draw(base, bterm, 0u, s_pm1, -1.0f);
        const float rd1 = trt_draw(base, bterm, 1u, s_pm1, -1.0f);
        const float rd2 = trt_draw(base, bterm, 2u, s_pm1, -1.0f);
        const float rrefl = trt_draw(base, bterm, 3u, s_01, 0.0f);
        trt_shade_vjp(s, table + 12 * (size_t)(live ? idx : 0), live, sky,
                      rd0, rd1, rd2, rrefl, use_sky != 0, g, d_s, d_w);
      } else {
        for (int k = 0; k < 9; ++k) d_s[k] = g[k];
      }
      for (int k = 0; k < 9; ++k) dst[(size_t)k * r + i] = d_s[k];
      for (int k = 12; k < 16; ++k) dst[(size_t)k * r + i] = 0.0f;
      if (live) key = idx;
    }
    for (int c = 0; c < 12; ++c) sdw[threadIdx.x * 13 + c] = d_w[c];
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    __syncwarp();
    const bool leader = key >= 0 && lane == __ffs(peers) - 1;
    float sum[12];
    if (leader) {
      for (int c = 0; c < 12; ++c) sum[c] = 0.0f;
      for (unsigned m = peers; m; m &= m - 1) {
        const float* q = sdw + (warp * 32 + __ffs(m) - 1) * 13;
        for (int c = 0; c < 12; ++c) sum[c] = sum[c] + q[c];
      }
    }
    for (int w = 0; w < n_warps; ++w) {
      if (warp == w && leader) {
        for (int c = 0; c < 12; ++c) {
          acc[12 * key + c] = acc[12 * key + c] + sum[c];
        }
      }
      __syncthreads();
    }
  }
  float* row = part + (size_t)blockIdx.x * 12 * n;
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) row[k] = acc[k];
}

// out[j] = sum over k in order of part[k, j], j < m.
__global__ void sum_parts_kernel(const float* __restrict__ part, int parts,
                                 int m, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
  for (int k = 0; k < parts; ++k) s = s + part[(size_t)k * m + j];
  out[j] = s;
}

int blocks_of(int r) {
  return (r + TRT_BOUNCE_THREADS - 1) / TRT_BOUNCE_THREADS;
}

}  // namespace

// The number of K6 partial rows for r lanes (the wrapper sizes them).
extern "C" int trt_bounce_bwd_parts(int r) {
  const int blocks = blocks_of(r);
  return blocks < TRT_BWD_PARTS ? blocks : TRT_BWD_PARTS;
}

// state, out [16, r]; table [n, 12]; bounce b; mask nullptr or
// [ceil(r / 256), n_tiles] i32; idx_out [r] i32.
extern "C" int trt_bounce_fwd(const float* state, float* out, int r,
                              const float* table, int n, int bounce,
                              const int* mask, int n_tiles, int block_n,
                              int use_sky, int* idx_out,
                              cudaStream_t stream) {
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (mask == nullptr) {
    n_tiles = 1;
    block_n = n;
  }
  if (n_tiles < 1 || block_n < 1 || (long)n_tiles * block_n < n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = trt_set_smem(bounce_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  bounce_fwd_kernel<<<blocks_of(r), TRT_BOUNCE_THREADS, smem, stream>>>(
      state, out, r, table, n, (uint32_t)bounce * TRT_MIX_BOUNCE, mask,
      n_tiles, block_n, use_sky, idx_out);
  return (int)cudaGetLastError();
}

// state, out [16, r]; table [n, 12]; idx [r] i32 (-1: no hit).
extern "C" int trt_bounce_replay(const float* state, float* out, int r,
                                 const float* table, const int* idx,
                                 int bounce, int use_sky,
                                 cudaStream_t stream) {
  if (r == 0) return 0;
  bounce_replay_kernel<<<blocks_of(r), TRT_BOUNCE_THREADS, 0, stream>>>(
      state, out, r, table, idx, (uint32_t)bounce * TRT_MIX_BOUNCE, use_sky);
  return (int)cudaGetLastError();
}

// state [16, r]; idx [r] i32; d_state [16, r] (d_out in, d_state_in out);
// part [trt_bounce_bwd_parts(r), n, 12] scratch; d_table [n, 12] out.
extern "C" int trt_bounce_bwd(const float* state, const int* idx,
                              const float* table, int n, float* d_state,
                              int r, int bounce, int use_sky, float* part,
                              float* d_table, cudaStream_t stream) {
  const size_t smem = ((size_t)12 * n + 13 * TRT_BOUNCE_THREADS) *
                      sizeof(float);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(bounce_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int m = 12 * n;
  int parts = 0;
  if (r > 0) {
    parts = trt_bounce_bwd_parts(r);
    bounce_bwd_kernel<<<parts, TRT_BOUNCE_THREADS, smem, stream>>>(
        state, idx, table, n, d_state, r, (uint32_t)bounce * TRT_MIX_BOUNCE,
        use_sky, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_parts_kernel<<<(m + 63) / 64, 64, 0, stream>>>(part, parts, m,
                                                      d_table);
  return (int)cudaGetLastError();
}
