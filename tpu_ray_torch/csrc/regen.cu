// K2: persistent-wavefront regen steps over the [24, R] state, in place,
// with an optional recording mode for the backward.
//
// Replaces tpu_ray/kernels/regen.py::regen_step: _regen_kernel (pallas_call
// at :868) and _regen_multi_kernel (steps > 1, pallas_call at :769),
// including their with_idx winner records, and _regen_list_kernel
// (regen_step with tri_lists, pallas_call at :812). Each step is the K1
// search over the shared-memory sphere table, then, on a triangle scene,
// the Möller-Trumbore fold over the triangles (common.cuh trt_tri_hit;
// the winner is the lowest id in the one id space on an exact tie:
// spheres 0..N-1, triangles N..P-1), then trt_step_tail (regen_step.cuh):
// the _step_tail semantics of regen.py:167-224, shading a triangle in the
// plane form. Four modes, named by the caller (kernels/regen.py):
// - the culled sphere search (sphere tiles, no triangle table): regen_step
//   on a sphere scene as the route runs it (regen_sph_kernel);
// - the sphere sweep (no tiles, no triangle table): every live lane folds
//   every sphere, the mode the cull replaced, kept to time against;
// - the triangle sweep (a triangle table, no tile boxes): every live lane
//   folds every triangle in id order, regen_step(tri_tab=,
//   tri_lists=None), #2's triangle mode;
// - the listed triangle mode (a triangle table and its tile boxes): each
//   256-lane block lists, at every step, the 128-triangle tiles its live
//   lanes' rays can reach (bounce_step.tri_block_lists at group 1, from
//   the state of that step) and folds only those, #4's
//   _regen_list_kernel, whose lists JAX builds on the host every step.
// The plain version is kernels/regen.py regen_steps_plain; this file
// repeats its f32 op sequence (see common.cuh on -fmad=false). Layout:
// kernels/regen.py.
//
// Bound on the H100: fp32 ALU. Each step of a lane searches the spheres
// (~20 flops a pair: 512 pairs for rtweekend in the sweep, ~40 and ~18
// slab tests of tile and group boxes in the culled search), the triangles
// of its mode
// (14, 24 or 46 flops a Möller-Trumbore pair by where it leaves the test:
// 10,368 triangles for trimesh in the sweep, the listed tiles' in the
// listed mode) and then shades (~200 flops); the lane's 96 B of state is
// read and written once per launch, so device memory is idle next to the
// ALUs. Recording adds 2 B of winner record per lane-step and a 96 B
// checkpoint per lane every seg steps.
//
// Design: one thread owns one lane for the whole launch and keeps its state
// in registers across all `steps` steps, so the forward render is a single
// launch (steps = spp * max_bounces); the TPU kernel's per-step HBM round
// trip of the state disappears. The sphere table sits in shared memory
// (16 B a sphere) and every thread reads the same sphere at once, a
// broadcast. Materials of the one winner per step come from the [P,12]
// table in global memory through L1/L2. A lane that is dead stays dead
// (alive is only set again by a live lane's regeneration); it advances its
// bounce row by the steps it skips, as the plain version does, and in
// recording mode writes the count of steps it took (t_end) instead of the
// TPU kernel's dead-block sentinel, leaving the records past it unwritten.
// - The culled sphere search (regen_sph_kernel): the Morton-permuted
//   sphere table is cut into tiles of 16 consecutive spheres (a sphere
//   that dwarfs the rest, rtweekend's ground, a tile of its own), each
//   with a box inflated past the f32 rounding of a hit's t, and groups of
//   4 tiles with the union of their boxes (kernels/regen.py
//   sphere_tiles); the boxes sit in shared memory beside the spheres.
//   Each step a lane takes its direction's reciprocal once, walks the
//   groups and tiles in ascending order and folds a tile only where its
//   ray enters the group's and the tile's box at no more than its best so
//   far (common.cuh trt_fold_sph_tiles): a skipped tile cannot hold the
//   nearest hit, and the ascending order with strict < keeps the lowest
//   id on an exact tie, so the winners are the sweep's bit for bit. A
//   tile that few lanes of a warp need is folded by the warp, two lanes
//   at a time, one sphere a thread (trt_fold_sph_tile_warp). The 32 lanes
//   of a warp run the steps together for those shuffles: a dead lane
//   stays in the loop, inactive, until its warp has none alive. On
//   rtweekend a lane-step tests ~40 of 482 real spheres' pairs (PERF.md).
// - The sphere sweep and the triangle sweep (regen_steps_kernel): a dead
//   lane leaves the loop at once. The triangle sweep reads the triangle
//   table (36 B a triangle, 373 KB for trimesh) from global memory
//   through L1/L2, where it stays
//   resident, the lanes of a warp reading the same triangle at once.
// - The listed mode (regen_list_kernel): the block's 256 threads run the
//   steps in lockstep, so that every barrier and warp vote is reached by
//   all of them; a dead lane stays in the loop, inactive (it feeds no
//   list and folds nothing), and the block leaves once none of its lanes
//   is alive. The tile boxes (24 B a tile, 1.9 KB for trimesh) sit in
//   shared memory for the whole launch. Each step the block builds and
//   folds its list as K10 does (common.cuh trt_block_list_ordered,
//   trt_fold_tiles_ordered): slab tests with the direction's reciprocal
//   taken once a step, the tiles sorted by the block's least entry
//   distance, each staged through shared memory only when a lane's ray
//   enters its box before that lane's best hit, a tile that few lanes of
//   a warp need tested by the whole warp for each of them in turn, and
//   the winner compared by (t, id). On trimesh this fold tests about a
//   tenth of the listed pairs and measured 4.5x faster than the ascending
//   fold of every listed tile, which tools/fold_order.py builds into a
//   copy of this kernel to compare (PERF.md). K8 and K9 fold their searches the same way.
#include "regen_step.cuh"

namespace {

template <bool RECORD>
__global__ void regen_steps_kernel(float* __restrict__ st, int r,
                                   const float* __restrict__ cam13,
                                   const float* __restrict__ table,
                                   const float* __restrict__ tri, int m,
                                   int steps, TrtRegenParams p,
                                   int16_t* __restrict__ rec,
                                   float* __restrict__ chk,
                                   int* __restrict__ t_end, int seg) {
  extern __shared__ float4 sph[];
  const int n = p.n_sph;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;

  const TrtCam c = trt_load_cam(cam13);
  TrtLane L = trt_load_lane(st, r, i);
  int k = 0;
  for (; k < steps; ++k) {
    if (!(L.alive > 0.5f)) {
      L.b_i = L.b_i + (float)(steps - k);
      break;
    }
    if (RECORD && k % seg == 0) {
      trt_store_lane(chk + (size_t)(k / seg) * 24 * r, r, i, L);
    }
    float t_hit;
    int idx;
    trt_nearest_sphere(sph, n, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, t_hit,
                       idx);
    trt_fold_tris(tri, 0, m, n, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, t_hit,
                  idx);
    if (!(t_hit < TRT_F32_MAX)) idx = -1;
    if (RECORD) rec[(size_t)k * r + i] = (int16_t)idx;
    trt_step_tail(L, c, table, idx, p);
  }
  if (RECORD) t_end[i] = k;
  trt_store_lane(st, r, i, L);
}

#define TRT_REGEN_THREADS 256

// The sphere mode's culled search. The sphere table (float4, n_sph of
// them), the tile and group boxes (6 floats each) and the tile and group
// starts (n_tiles + 1 and n_groups + 1 ints) sit in dynamic shared memory.
// The 32 lanes of a warp run the steps together, so that the warp-shared
// fold's shuffles reach all of them: a dead lane stays in the loop,
// inactive, and the warp leaves once none of its lanes is alive (b_i and
// t_end as in regen_steps_kernel). stats (nullptr, or 3 u64 added to):
// boxes tested (groups and tiles), tiles folded, ray-sphere pairs tested,
// over the live lane-steps.
template <bool RECORD>
__global__ void __launch_bounds__(TRT_REGEN_THREADS)
regen_sph_kernel(float* __restrict__ st, int r,
                 const float* __restrict__ cam13,
                 const float* __restrict__ table,
                 const float* __restrict__ boxes,
                 const int* __restrict__ starts, int n_tiles,
                 const float* __restrict__ gboxes,
                 const int* __restrict__ gstarts, int n_groups, float o_lim,
                 int steps, TrtRegenParams p,
                 int16_t* __restrict__ rec, float* __restrict__ chk,
                 int* __restrict__ t_end, int seg,
                 unsigned long long* __restrict__ stats) {
  extern __shared__ float4 sph[];
  const int n = p.n_sph;
  float* box = reinterpret_cast<float*>(sph + n);
  float* gbox = box + 6 * n_tiles;
  int* tst = reinterpret_cast<int*>(gbox + 6 * n_groups);
  int* gst = tst + n_tiles + 1;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  for (int k = threadIdx.x; k < 6 * n_tiles; k += blockDim.x) {
    box[k] = boxes[k];
  }
  for (int k = threadIdx.x; k < 6 * n_groups; k += blockDim.x) {
    gbox[k] = gboxes[k];
  }
  for (int k = threadIdx.x; k <= n_tiles; k += blockDim.x) tst[k] = starts[k];
  for (int k = threadIdx.x; k <= n_groups; k += blockDim.x) {
    gst[k] = gstarts[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  const TrtCam c = trt_load_cam(cam13);
  TrtLane L = {};
  if (in) L = trt_load_lane(st, r, i);
  int t_lane = steps;  // the steps this lane was alive for
  unsigned counts[3] = {0u, 0u, 0u};
  for (int k = 0; k < steps; ++k) {
    const bool alive = in && L.alive > 0.5f;
    if (in && !alive && t_lane == steps) {
      t_lane = k;
      L.b_i = L.b_i + (float)(steps - k);
    }
    if (!__any_sync(0xffffffffu, alive)) break;   // uniform in the warp
    if (RECORD && alive && k % seg == 0) {
      trt_store_lane(chk + (size_t)(k / seg) * 24 * r, r, i, L);
    }
    float best;
    int bi;
    trt_fold_sph_tiles(sph, box, tst, gbox, gst, n_groups, o_lim, alive,
                       L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, best, bi,
                       counts);
    if (alive) {
      const int idx = best < TRT_F32_MAX ? bi : -1;
      if (RECORD) rec[(size_t)k * r + i] = (int16_t)idx;
      trt_step_tail(L, c, table, idx, p);
    }
  }
  if (stats) {
    for (int q = 0; q < 3; ++q) {
      const unsigned v = __reduce_add_sync(0xffffffffu, counts[q]);
      if ((threadIdx.x & 31) == 0) {
        atomicAdd(stats + q, (unsigned long long)v);
      }
    }
  }
  if (!in) return;
  if (RECORD) t_end[i] = t_lane;
  trt_store_lane(st, r, i, L);
}

// The listed mode. boxes [n_tiles, 6]: the inflated tile boxes, tile t
// holding triangles [t * block_m, (t + 1) * block_m). stats (nullptr, or
// 3 u64 added to): listed tiles summed over the live block-steps, live
// block-steps, ray-triangle pairs tested. Dynamic shared memory: n_sph
// spheres (float4), the ordered list (trt_pow2_at_least(n_tiles) u64),
// the boxes (6 * n_tiles floats), a staged tile (9 * block_m floats) and
// the group boxes (6 floats a group of 32 tiles).
template <bool RECORD>
__global__ void __launch_bounds__(TRT_REGEN_THREADS, 2)
regen_list_kernel(float* __restrict__ st, int r,
                  const float* __restrict__ cam13,
                  const float* __restrict__ table,
                  const float* __restrict__ tri, int m,
                  const float* __restrict__ boxes, int n_tiles, int block_m,
                  int steps, TrtRegenParams p, int16_t* __restrict__ rec,
                  float* __restrict__ chk, int* __restrict__ t_end, int seg,
                  unsigned long long* __restrict__ stats) {
  extern __shared__ float4 sph[];
  const int n = p.n_sph;
  unsigned long long* ord = reinterpret_cast<unsigned long long*>(sph + n);
  float* box = reinterpret_cast<float*>(ord + trt_pow2_at_least(n_tiles));
  float* tile = box + 6 * n_tiles;
  float* gbox = tile + 9 * block_m;
  __shared__ int s_cnt;
  __shared__ unsigned s_wmax[32];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  for (int k = threadIdx.x; k < 6 * n_tiles; k += blockDim.x) {
    box[k] = boxes[k];
  }
  __syncthreads();
  trt_group_boxes(box, n_tiles, gbox);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  const TrtCam c = trt_load_cam(cam13);
  TrtLane L = {};
  if (in) L = trt_load_lane(st, r, i);
  int t_lane = steps;  // the steps this lane was alive for
  int tested = 0;      // pairs this lane tested, for stats
  for (int k = 0; k < steps; ++k) {
    const bool alive = in && L.alive > 0.5f;
    if (in && !alive && t_lane == steps) {
      t_lane = k;
      L.b_i = L.b_i + (float)(steps - k);
    }
    // uniform in the block: every barrier below is reached by all threads
    if (!__syncthreads_or(alive)) break;
    if (RECORD && alive && k % seg == 0) {
      trt_store_lane(chk + (size_t)(k / seg) * 24 * r, r, i, L);
    }
    float best = TRT_F32_MAX;
    int bi = 0;
    if (alive) {
      trt_fold_spheres(sph, 0, n, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, best,
                       bi);
    }
    const TrtRay ray = trt_ray(L.ox, L.oy, L.oz, L.dx, L.dy, L.dz);
    const int cnt = trt_block_list_ordered(alive, ray, box, gbox, n_tiles,
                                           ord, &s_cnt);
    trt_fold_tiles_ordered(tri, m, block_m, ord, cnt, box, tile, s_wmax, n,
                           alive, ray, best, bi, tested);
    if (stats && threadIdx.x == 0) {
      atomicAdd(stats, (unsigned long long)cnt);
      atomicAdd(stats + 1, 1ull);
    }
    if (alive) {
      const int idx = best < TRT_F32_MAX ? bi : -1;
      if (RECORD) rec[(size_t)k * r + i] = (int16_t)idx;
      trt_step_tail(L, c, table, idx, p);
    }
  }
  if (stats) {
    const unsigned pairs = __reduce_add_sync(
        0xffffffffu, (unsigned)tested);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats + 2, (unsigned long long)pairs);
    }
  }
  if (!in) return;
  if (RECORD) t_end[i] = t_lane;
  trt_store_lane(st, r, i, L);
}

template <bool RECORD>
int launch(float* state, int r, const float* cam13, const float* table,
           int n, const float* tri, int m, const float* boxes, int n_tiles,
           unsigned long long* stats, int steps, int use_sky,
           int max_bounces, int width, int height, float film_w,
           float film_h, int16_t* rec, float* chk, int* t_end, int seg,
           cudaStream_t stream) {
  if (m < 0 || m > n || (m > 0 && tri == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (boxes == nullptr ? stats != nullptr
                       : (m == 0 || n_tiles < 1 || m % n_tiles != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (RECORD && seg <= 0) return (int)cudaErrorInvalidValue;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h, n - m};
  const int blocks = (r + TRT_REGEN_THREADS - 1) / TRT_REGEN_THREADS;
  if (boxes == nullptr) {
    const size_t smem = (size_t)(n - m) * sizeof(float4);
    if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    cudaError_t err = trt_set_smem(regen_steps_kernel<RECORD>, smem);
    if (err != cudaSuccess) return (int)err;
    if (r == 0 || steps <= 0) return 0;
    regen_steps_kernel<RECORD><<<blocks, TRT_REGEN_THREADS, smem, stream>>>(
        state, r, cam13, table, tri, m, steps, p, rec, chk, t_end, seg);
    return (int)cudaGetLastError();
  }
  const int block_m = m / n_tiles;
  const size_t smem =
      (size_t)(n - m) * sizeof(float4) +
      (size_t)trt_pow2_at_least(n_tiles) * 8 +
      ((size_t)6 * n_tiles + 9 * block_m + 6 * ((n_tiles + 31) / 32)) *
          sizeof(float);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_list_kernel<RECORD>, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0 || steps <= 0) return 0;
  regen_list_kernel<RECORD><<<blocks, TRT_REGEN_THREADS, smem, stream>>>(
      state, r, cam13, table, tri, m, boxes, n_tiles, block_m, steps, p, rec,
      chk, t_end, seg, stats);
  return (int)cudaGetLastError();
}

template <bool RECORD>
int launch_sph(float* state, int r, const float* cam13, const float* table,
               int n, const float* boxes, const int* starts, int n_tiles,
               const float* gboxes, const int* gstarts, int n_groups,
               float o_lim, unsigned long long* stats, int steps,
               int use_sky, int max_bounces, int width, int height,
               float film_w, float film_h, int16_t* rec, float* chk,
               int* t_end, int seg, cudaStream_t stream) {
  if (boxes == nullptr || starts == nullptr || n_tiles < 1 ||
      gboxes == nullptr || gstarts == nullptr || n_groups < 1 ||
      n_groups > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  if (RECORD && seg <= 0) return (int)cudaErrorInvalidValue;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h, n};
  const size_t smem = (size_t)n * sizeof(float4) +
                      (size_t)6 * (n_tiles + n_groups) * sizeof(float) +
                      (size_t)(n_tiles + n_groups + 2) * sizeof(int);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_sph_kernel<RECORD>, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0 || steps <= 0) return 0;
  const int blocks = (r + TRT_REGEN_THREADS - 1) / TRT_REGEN_THREADS;
  regen_sph_kernel<RECORD><<<blocks, TRT_REGEN_THREADS, smem, stream>>>(
      state, r, cam13, table, boxes, starts, n_tiles, gboxes, gstarts,
      n_groups, o_lim, steps, p, rec, chk, t_end, seg, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// The sphere mode's culled search (regen_sph_kernel): state [24, r]; table
// [n, 12] sphere rows; boxes [n_tiles, 6] and starts [n_tiles + 1] the
// sphere tiles, gboxes [n_groups, 6] and gstarts [n_groups + 1] their
// groups (kernels/regen.py sphere_tiles); o_lim their origin bound;
// stats nullptr
// or 3 u64 (see regen_sph_kernel). rec nullptr: the forward; else the
// recording mode, rec/chk/t_end as trt_regen_steps_record's.
extern "C" int trt_regen_sph(float* state, int r, const float* cam13,
                             const float* table, int n, const float* boxes,
                             const int* starts, int n_tiles,
                             const float* gboxes, const int* gstarts,
                             int n_groups, float o_lim,
                             unsigned long long* stats,
                             int steps, int use_sky, int max_bounces,
                             int width, int height, float film_w,
                             float film_h, int16_t* rec, float* chk,
                             int* t_end, int seg, cudaStream_t stream) {
  if (rec == nullptr) {
    return launch_sph<false>(state, r, cam13, table, n, boxes, starts,
                             n_tiles, gboxes, gstarts, n_groups, o_lim,
                             stats, steps, use_sky,
                             max_bounces, width, height, film_w, film_h,
                             nullptr, nullptr, nullptr, 1, stream);
  }
  return launch_sph<true>(state, r, cam13, table, n, boxes, starts, n_tiles,
                          gboxes, gstarts, n_groups, o_lim, stats,
                          steps, use_sky, max_bounces,
                          width, height, film_w, film_h, rec, chk, t_end,
                          seg, stream);
}

// state [24, r]; table [n, 12] (n - m sphere rows, then m triangle rows);
// tri [m, 9] v0|e1|e2 (nullptr when m = 0); boxes [n_tiles, 6] the tile
// boxes of tri for the listed mode, nullptr for the sweep; stats: see
// regen_list_kernel (nullptr, or the listed mode's).
extern "C" int trt_regen_steps(float* state, int r, const float* cam13,
                               const float* table, int n, const float* tri,
                               int m, const float* boxes, int n_tiles,
                               unsigned long long* stats, int steps,
                               int use_sky, int max_bounces, int width,
                               int height, float film_w, float film_h,
                               cudaStream_t stream) {
  return launch<false>(state, r, cam13, table, n, tri, m, boxes, n_tiles,
                       stats, steps, use_sky, max_bounces, width, height,
                       film_w, film_h, nullptr, nullptr, nullptr, 1, stream);
}

// Recording mode: rec [steps, r] i16 (winner id on live lanes, -1 on a
// miss; entries at k >= t_end[i] unwritten), chk [ceil(steps/seg), 24, r]
// (the lane's state at every alive step k % seg == 0), t_end [r] i32.
extern "C" int trt_regen_steps_record(float* state, int r,
                                      const float* cam13, const float* table,
                                      int n, const float* tri, int m,
                                      const float* boxes, int n_tiles,
                                      unsigned long long* stats, int steps,
                                      int use_sky, int max_bounces,
                                      int width, int height, float film_w,
                                      float film_h, int16_t* rec, float* chk,
                                      int* t_end, int seg,
                                      cudaStream_t stream) {
  return launch<true>(state, r, cam13, table, n, tri, m, boxes, n_tiles,
                      stats, steps, use_sky, max_bounces, width, height,
                      film_w, film_h, rec, chk, t_end, seg, stream);
}
