// K4, K8, K5, K6: the bounce kernels of the per-sample fused route
// (kernels/bounce_step.py make_fused_sample: one sample's raygen, then
// max_bounces bounces forward, and the reverse sweep in its backward).
//
// State [16, r] f32, row-major (row k at st + k * r), unpadded: 0-2
// origin, 3-5 direction, 6-8 attenuation, 9-11 colour, 12 alive (0/1),
// 13 rng stream base (u32 bits), 14-15 unused (passed through). Table
// [n, 12] f32 (bounce_step.prim_table of the Morton-permuted scene: n_sph
// sphere rows, then on a triangle scene a plane-form row per triangle;
// a winner id at or past n_sph is a triangle). The draws of bounce b are
// keyed by bterm = b * TRT_MIX_BOUNCE.
//
// K4 bounce_fwd replaces tpu_ray/kernels/bounce_step.py::bounce_fwd
// (_fwd_kernel, pallas_call at :1548): the nearest-hit search, then the
// shading (shade.cuh trt_shade, K2's own). -> the new state and the
// winner id (-1 on a miss or a dead lane). Plain version:
// bounce_fwd_plain. Three ways to search the spheres, named by the
// caller: the route's culled search (the sphere tiles of
// kernels/regen.py sphere_tiles), a conservative (ray block x sphere
// tile) mask, or every sphere. Its triangle mode (a triangle table, the
// JAX kernel's tri_tab) then folds every triangle in ascending id with
// strict < (ids offset by n_sph), as K2's triangle sweep does, and shades
// a triangle winner with the triangle branch.
//   Bound on the H100: fp32 ALU in the search (~20 flops a sphere pair
//   and a tile box, 14-46 a triangle pair) against 132 B of state and id
//   a lane. Culled, a lane-bounce of rtweekend tests ~40 sphere pairs
//   and ~18 boxes, where every sphere is 482 pairs: the floor is then the
//   state's bytes.
//   Design: one thread per lane, 256-lane blocks. The sphere (centre,
//   radius) table sits in shared memory (16 B a sphere), and with it the
//   sphere tiles' boxes, group boxes and starts. The culled search is
//   K2's (common.cuh trt_fold_sph_tiles): a lane folds a 16-sphere tile
//   only where its ray enters the tile's inflated box (and its group's) at
//   no more than its best so far, in ascending order with strict <, so the
//   winner is the full fold's bit for bit; a tile that few lanes of a warp
//   need is folded by the warp. The lanes of a warp stay together for its
//   shuffles: a dead lane, or one past r, stays in the fold inactive, and
//   a warp with no alive lane skips it. The masked and full searches fold
//   the broadcast spheres one by one (the mask's 128-sphere tiles skipped
//   by the whole block). The triangle table (36 B a triangle) is read
//   through L1/L2, the lanes of a warp reading the same triangle at once.
//   The winner's materials come from the [n,12] table in global memory.
//   The TPU kernel's (ray block x tile) grid, bf16x6 search tables, packed
//   argmin and one-hot MXU gather are not carried over.
//
// K8 bounce_fwd_list replaces bounce_fwd_list (_fwd_list_kernel,
// pallas_call at :1824), with exact_argmin: one bounce of a triangle
// scene. Each alive lane folds every sphere, then the triangles of the
// tiles its block can reach (ids offset by n_sph), then shades with the
// triangle branch on triangle winners. Plain version:
// bounce_fwd_list_plain.
//   Bound on the H100: fp32 ALU. Real sphere pairs x 20 flops plus each
//   ray-triangle pair tested charged by the stage at which it leaves
//   trt_tri_hit (14, 24 or 46 flops), against 132 B of state a lane.
//   Design: K2's listed fold (regen.cu regen_list_kernel) for one bounce.
//   One thread per lane, 256-lane blocks; the tile boxes (24 B a tile)
//   and their 32-tile group boxes sit in shared memory. The block lists
//   the tiles its alive lanes' rays reach and sorts them by the least
//   entry distance (common.cuh trt_block_list_ordered: tri_block_lists at
//   block_r = 256, group 1, ordered front to back, with no [B, T] list in
//   HBM and no host sync). It then walks them front to back
//   (trt_fold_tiles_ordered): a tile is staged into shared memory only
//   when a lane's ray enters its box before that lane's best hit, a tile
//   that few lanes of a warp need is tested by the whole warp for each of
//   them in turn, the walk stops once no lane's best reaches the next
//   tile, and the winner is compared by (t, id), so an exact tie keeps the
//   lowest id as the ascending fold does. The block's threads run
//   together: every barrier and vote is reached by all of them, a dead
//   lane or one past r staying inactive. A block with no alive lane
//   builds no list and writes its state back with idx -1 (block_alive in
//   the TPU kernel). A lane folds ~10% of its block's listed pairs this
//   way; the ascending fold of every listed tile for every lane was 5.9x
//   slower on an H100 (PERF.md). The TPU kernel's SMEM list table,
//   list_group, bf16 split tables and packed argmin are not carried over.
//
// K5 bounce_replay replaces bounce_replay (_replay_kernel, pallas_call at
// :1871): the same shading from a saved winner id, no search. Given K4's
// or K8's ids it gives their state bit for bit (same device function).
// Plain version: bounce_replay_plain.
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
//   d_winner into an [n,12] accumulator in a fixed order: within a warp
//   the lanes of one winner (__match_any_sync) are summed by their
//   lowest lane in lane order, then the warps add their sums one warp at
//   a time. The accumulator sits in shared memory up to TRT_BWD_SMEM_ROW
//   (rtweekend: 24.6 KB), and past it (trimesh: 10,496 x 48 B) in block
//   k's own row of the partials in global memory, zeroed by the block,
//   which no other block touches (K3's scheme, regen_bwd.cu). Either way
//   row k of the partials ([parts, n, 12], 129 MB at 256 parts on
//   trimesh) ends as block k's sum. Launch 2 sums the partials over k in
//   order, one thread per entry. The TPU kernel carried d_table across a
//   sequential grid; Hopper's blocks run in parallel and in no order.
//   On a triangle scene (n_sph < n) the transpose runs its triangle
//   branch (has_tris) on every lane, as K3 does.
#include "shade.cuh"

// The ray block: the threads of a K4/K5/K6 block and the row of the cull
// mask (kernels/bounce_step.py BLOCK_R).
#define TRT_BOUNCE_THREADS 256
// The most blocks of K6's first launch (its partials' leading dimension).
#define TRT_BWD_PARTS 256
// The largest K6 accumulator kept in shared memory (K3's threshold).
#define TRT_BWD_SMEM_ROW (96 * 1024)

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
// tile t holds spheres [t * block_n, min((t + 1) * block_n, n_sph)). sp:
// the culled search's tiles (not with a mask). TRI: the triangle mode,
// tri [m, 9] v0|e1|e2 with ids n_sph + j. stats (nullptr, or 3 u64 added
// to, with sp): boxes tested (groups and tiles), tiles folded, ray-sphere
// pairs tested over the alive lanes. Dynamic shared memory: n_sph spheres
// (float4), then with sp the tile and group boxes (6 floats each) and
// starts (n_tiles + 1 and n_groups + 1 ints).
template <bool TRI>
__global__ void __launch_bounds__(TRT_BOUNCE_THREADS)
bounce_fwd_kernel(const float* __restrict__ st, float* __restrict__ out,
                  int r, const float* __restrict__ table, int n_sph,
                  uint32_t bterm, const int* __restrict__ mask, int n_tiles,
                  int block_n, TrtSphTiles sp, const float* __restrict__ tri,
                  int m, int use_sky, int* __restrict__ idx_out,
                  unsigned long long* __restrict__ stats) {
  extern __shared__ float4 sph[];
  float* box = reinterpret_cast<float*>(sph + n_sph);
  float* gbox = box + 6 * sp.n_tiles;
  int* tst = reinterpret_cast<int*>(gbox + 6 * sp.n_groups);
  int* gst = tst + sp.n_tiles + 1;
  for (int k = threadIdx.x; k < n_sph; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  if (sp.boxes) {
    for (int k = threadIdx.x; k < 6 * sp.n_tiles; k += blockDim.x) {
      box[k] = sp.boxes[k];
    }
    for (int k = threadIdx.x; k < 6 * sp.n_groups; k += blockDim.x) {
      gbox[k] = sp.gboxes[k];
    }
    for (int k = threadIdx.x; k <= sp.n_tiles; k += blockDim.x) {
      tst[k] = sp.starts[k];
    }
    for (int k = threadIdx.x; k <= sp.n_groups; k += blockDim.x) {
      gst[k] = sp.gstarts[k];
    }
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  TrtBounceLane L = {};
  if (in) L = load_lane(st, r, i);
  const bool alive = in && L.alive > 0.5f;
  float best = TRT_F32_MAX;
  int bi = 0;
  unsigned counts[3] = {0u, 0u, 0u};
  if (sp.boxes) {
    // every lane of the warp runs the fold (its shuffles), the inactive
    // ones folding nothing; a warp with no alive lane passes it by
    if (__any_sync(0xffffffffu, alive)) {
      trt_fold_sph_tiles(sph, box, tst, gbox, gst, sp.n_groups, sp.o_lim,
                         alive, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, best, bi,
                         counts);
    }
  } else if (alive) {
    const int* row = mask ? mask + (size_t)blockIdx.x * n_tiles : nullptr;
    for (int t = 0; t < n_tiles; ++t) {
      if (row && row[t] == 0) continue;
      trt_fold_spheres(sph, t * block_n, min((t + 1) * block_n, n_sph), L.ox,
                       L.oy, L.oz, L.dx, L.dy, L.dz, best, bi);
    }
  }
  if (TRI && alive) {
    trt_fold_tris(tri, 0, m, n_sph, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, best,
                  bi);
  }
  int idx = -1;
  if (alive) {
    if (best < TRT_F32_MAX) idx = bi;
    trt_shade(L, idx >= 0 ? table + 12 * (size_t)idx : nullptr, bterm,
              use_sky != 0, TRI && idx >= n_sph);
  }
  if (stats) {
    for (int q = 0; q < 3; ++q) {
      const unsigned v = __reduce_add_sync(0xffffffffu, counts[q]);
      if ((threadIdx.x & 31) == 0 && v) {
        atomicAdd(stats + q, (unsigned long long)v);
      }
    }
  }
  if (!in) return;
  L.alive = idx >= 0 ? 1.0f : 0.0f;
  store_lane(out, r, i, L);
  idx_out[i] = idx;
}

// tri [m, 9] v0|e1|e2 (ids n_sph + j); boxes [n_tiles, 6], tile t holds
// triangles [t * block_m, min((t + 1) * block_m, m)). stats (nullptr, or
// 3 u64 added to): listed tiles summed over the live blocks, live blocks,
// ray-triangle pairs tested (a tile's triangles a lane tested). Dynamic
// shared memory: n_sph spheres (float4), the ordered list
// (trt_pow2_at_least(n_tiles) u64), the boxes (6 * n_tiles floats), a
// staged tile (9 * block_m floats) and the group boxes (6 floats a group
// of 32 tiles).
__global__ void __launch_bounds__(TRT_BOUNCE_THREADS, 2)
bounce_fwd_list_kernel(const float* __restrict__ st, float* __restrict__ out,
                       int r, const float* __restrict__ table, int n_sph,
                       const float* __restrict__ tri, int m,
                       const float* __restrict__ boxes, int n_tiles,
                       int block_m, uint32_t bterm, int use_sky,
                       int* __restrict__ idx_out,
                       unsigned long long* __restrict__ stats) {
  extern __shared__ float4 sph[];
  unsigned long long* ord = reinterpret_cast<unsigned long long*>(sph + n_sph);
  float* box = reinterpret_cast<float*>(ord + trt_pow2_at_least(n_tiles));
  float* tile = box + 6 * n_tiles;
  float* gbox = tile + 9 * block_m;
  __shared__ int s_cnt;
  __shared__ unsigned s_wmax[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  TrtBounceLane L = {};
  if (in) L = load_lane(st, r, i);
  const bool alive = in && L.alive > 0.5f;
  int idx = -1;
  // every branch below on block_alive is taken by the whole block, so
  // each __syncthreads and warp vote is reached by all its threads
  if (__syncthreads_or(alive)) {
    for (int k = threadIdx.x; k < n_sph; k += blockDim.x) {
      const float* w = table + 12 * (size_t)k;
      sph[k] = make_float4(w[0], w[1], w[2], w[3]);
    }
    for (int k = threadIdx.x; k < 6 * n_tiles; k += blockDim.x) {
      box[k] = boxes[k];
    }
    __syncthreads();
    trt_group_boxes(box, n_tiles, gbox);
    float best = TRT_F32_MAX;
    int bi = 0;
    if (alive) {
      trt_fold_spheres(sph, 0, n_sph, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz,
                       best, bi);
    }
    const TrtRay ray = trt_ray(L.ox, L.oy, L.oz, L.dx, L.dy, L.dz);
    const int cnt = trt_block_list_ordered(alive, ray, box, gbox, n_tiles,
                                           ord, &s_cnt);
    int tested = 0;
    trt_fold_tiles_ordered(tri, m, block_m, ord, cnt, box, tile, s_wmax,
                           n_sph, alive, ray, best, bi, tested);
    if (stats) {
      if (threadIdx.x == 0) {
        atomicAdd(stats, (unsigned long long)cnt);
        atomicAdd(stats + 1, 1ull);
      }
      const unsigned pairs = __reduce_add_sync(
          0xffffffffu, (unsigned)tested);
      if ((threadIdx.x & 31) == 0 && pairs) {
        atomicAdd(stats + 2, (unsigned long long)pairs);
      }
    }
    if (alive && best < TRT_F32_MAX) idx = bi;
  }
  if (alive) {
    trt_shade(L, idx >= 0 ? table + 12 * (size_t)idx : nullptr, bterm,
              use_sky != 0, idx >= n_sph);
  }
  if (!in) return;
  L.alive = idx >= 0 ? 1.0f : 0.0f;
  store_lane(out, r, i, L);
  idx_out[i] = idx;
}

__global__ void bounce_replay_kernel(const float* __restrict__ st,
                                     float* __restrict__ out, int r,
                                     const float* __restrict__ table,
                                     int n_sph,
                                     const int* __restrict__ idx_in,
                                     uint32_t bterm, int use_sky) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  TrtBounceLane L = load_lane(st, r, i);
  const int idx = idx_in[i];
  const bool live = idx >= 0;
  if (live || L.alive > 0.5f) {
    trt_shade(L, live ? table + 12 * (size_t)idx : nullptr, bterm,
              use_sky != 0, idx >= n_sph);
  }
  L.alive = live ? 1.0f : 0.0f;
  store_lane(out, r, i, L);
}

// dst: d_state_out in, d_state_in out. part: [gridDim.x, n * 12].
// Dynamic shared memory: 13 floats a thread of staged d_winner (13, not
// 12: consecutive threads then start in different banks), then the
// [n, 12] accumulator when smem_row is set (else it is part's row).
__global__ void bounce_bwd_kernel(const float* __restrict__ st,
                                  const int* __restrict__ idx_in,
                                  const float* __restrict__ table, int n,
                                  int n_sph, float* __restrict__ dst, int r,
                                  uint32_t bterm, int use_sky, int smem_row,
                                  float* __restrict__ part) {
  extern __shared__ float smem[];
  float* sdw = smem;
  float* acc = smem_row ? smem + 13 * blockDim.x
                        : part + (size_t)blockIdx.x * 12 * n;
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();
  const bool has_tris = n_sph < n;
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
                      rd0, rd1, rd2, rrefl, use_sky != 0, g, d_s, d_w,
                      has_tris, idx >= n_sph);
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
  if (smem_row) {
    float* row = part + (size_t)blockIdx.x * 12 * n;
    for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) row[k] = acc[k];
  }
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

// state, out [16, r]; table [n_sph + m, 12]; bounce b; mask nullptr or
// [ceil(r / 256), n_tiles] i32 over the spheres; the sphere tiles boxes
// [n_stiles, 6], starts [n_stiles + 1], gboxes [n_groups, 6], gstarts
// [n_groups + 1] and o_lim, boxes nullptr for none (not with a mask); tri
// [m, 9] for the triangle mode, nullptr with m = 0; stats nullptr or 3
// u64 (with the sphere tiles, see bounce_fwd_kernel); idx_out [r] i32.
extern "C" int trt_bounce_fwd(const float* state, float* out, int r,
                              const float* table, int n_sph, int bounce,
                              const int* mask, int n_tiles, int block_n,
                              const float* boxes, const int* starts,
                              int n_stiles, const float* gboxes,
                              const int* gstarts, int n_groups, float o_lim,
                              const float* tri, int m, int use_sky,
                              unsigned long long* stats, int* idx_out,
                              cudaStream_t stream) {
  if (n_sph < 0 || m < 0 || (m > 0) != (tri != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  TrtSphTiles sp{nullptr, nullptr, 0, nullptr, nullptr, 0, 0.0f};
  if (boxes != nullptr) {
    if (mask != nullptr || starts == nullptr || gboxes == nullptr ||
        gstarts == nullptr || n_stiles < 1 || n_groups < 1 ||
        n_groups > n_stiles) {
      return (int)cudaErrorInvalidValue;
    }
    sp = TrtSphTiles{boxes, starts, n_stiles, gboxes, gstarts, n_groups,
                     o_lim};
  } else if (stats != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (size_t)n_sph * sizeof(float4) +
      (size_t)6 * (sp.n_tiles + sp.n_groups) * sizeof(float) +
      (boxes ? (size_t)(sp.n_tiles + sp.n_groups + 2) * sizeof(int) : 0);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (mask == nullptr) {
    n_tiles = 1;
    block_n = n_sph;
  }
  if (n_tiles < 1 || (block_n < 1 && n_sph > 0) ||
      (long)n_tiles * block_n < n_sph) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = m > 0 ? bounce_fwd_kernel<true> : bounce_fwd_kernel<false>;
  cudaError_t err = trt_set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  kernel<<<blocks_of(r), TRT_BOUNCE_THREADS, smem, stream>>>(
      state, out, r, table, n_sph, (uint32_t)bounce * TRT_MIX_BOUNCE, mask,
      n_tiles, block_n, sp, tri, m, use_sky, idx_out, stats);
  return (int)cudaGetLastError();
}

// state, out [16, r]; table [n, 12] (n_sph sphere rows, then
// triangles); tri [m, 9] with n_sph + m = n; boxes [n_tiles, 6], tile t
// holding triangles [t * block_m, (t + 1) * block_m); stats nullptr or 3
// u64 (see bounce_fwd_list_kernel); idx_out [r] i32.
extern "C" int trt_bounce_fwd_list(const float* state, float* out, int r,
                                   const float* table, int n_sph,
                                   const float* tri, int m,
                                   const float* boxes, int n_tiles,
                                   int block_m, int bounce, int use_sky,
                                   unsigned long long* stats, int* idx_out,
                                   cudaStream_t stream) {
  if (n_sph < 0 || m < 1 || n_tiles < 1 || block_m < 1 ||
      (long)n_tiles * block_m < m) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (size_t)n_sph * sizeof(float4) +
      (size_t)trt_pow2_at_least(n_tiles) * 8 +
      ((size_t)6 * n_tiles + 9 * block_m + 6 * ((n_tiles + 31) / 32)) *
          sizeof(float);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(bounce_fwd_list_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  bounce_fwd_list_kernel<<<blocks_of(r), TRT_BOUNCE_THREADS, smem, stream>>>(
      state, out, r, table, n_sph, tri, m, boxes, n_tiles, block_m,
      (uint32_t)bounce * TRT_MIX_BOUNCE, use_sky, idx_out, stats);
  return (int)cudaGetLastError();
}

// state, out [16, r]; table [n, 12], rows past n_sph triangles; idx [r]
// i32 (-1: no hit).
extern "C" int trt_bounce_replay(const float* state, float* out, int r,
                                 const float* table, int n_sph,
                                 const int* idx, int bounce, int use_sky,
                                 cudaStream_t stream) {
  if (r == 0) return 0;
  bounce_replay_kernel<<<blocks_of(r), TRT_BOUNCE_THREADS, 0, stream>>>(
      state, out, r, table, n_sph, idx, (uint32_t)bounce * TRT_MIX_BOUNCE,
      use_sky);
  return (int)cudaGetLastError();
}

// state [16, r]; idx [r] i32; table [n, 12], rows past n_sph triangles;
// d_state [16, r] (d_out in, d_state_in out); part
// [trt_bounce_bwd_parts(r), n, 12] scratch; d_table [n, 12] out.
extern "C" int trt_bounce_bwd(const float* state, const int* idx,
                              const float* table, int n, int n_sph,
                              float* d_state, int r, int bounce, int use_sky,
                              float* part, float* d_table,
                              cudaStream_t stream) {
  if (n_sph < 0 || n_sph > n) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)12 * n * sizeof(float);
  const int smem_row = row <= TRT_BWD_SMEM_ROW;
  const size_t smem = (size_t)13 * TRT_BOUNCE_THREADS * sizeof(float) +
                      (smem_row ? row : 0);
  cudaError_t err = trt_set_smem(bounce_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int m = 12 * n;
  int parts = 0;
  if (r > 0) {
    parts = trt_bounce_bwd_parts(r);
    bounce_bwd_kernel<<<parts, TRT_BOUNCE_THREADS, smem, stream>>>(
        state, idx, table, n, n_sph, d_state, r,
        (uint32_t)bounce * TRT_MIX_BOUNCE, use_sky, smem_row, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_parts_kernel<<<(m + 63) / 64, 64, 0, stream>>>(part, parts, m,
                                                      d_table);
  return (int)cudaGetLastError();
}
