// K10: nearest triangle hit per ray for a soup past the residency rule,
// over the tiles each ray's block can reach.
//
// Replaces tpu_ray/kernels/tri_intersect.py::nearest_hit_tri_stream
// (_kernel_stream, pallas_call at :315). Contract: the exact nearest
// Möller-Trumbore hit of ops/intersect_tri.py nearest_hit_tri (lowest index
// on a tie, t = 1e30 and idx = 0 on a miss) over the triangles of the tiles
// that the ray's 256-lane block lists (kernels/bounce_step.py
// tri_block_lists at group 1: a tile is listed when an alive lane's ray
// meets its inflated box). Dead lanes (alive[i] == 0) feed no list and
// return a miss. A tile no lane reaches holds no lane's hit, except where
// Möller-Trumbore accepts a grazing hit outside its tile's box, which the
// full sweep (K7) folds and the list skips.
//
// The TPU kernel's SMEM lists built by XLA outside the kernel, its
// double-buffered HBM->VMEM DMA of bf16 coefficient tiles and its bf16x6
// MXU form are TPU mechanism and are not carried over: as K2, K8 and K9 do,
// each block builds its own list in the launch, with the plain version's
// f32 op order (trt_tri_hit), so kernel and plain version agree bit for
// bit. A block with no alive lane leaves at once.
//
// Bound on the H100: fp32 ALU. Each listed ray-triangle pair costs 14,
// 24 or 46 flops by where it leaves trt_tri_hit, and the list build one
// slab test (~30 flops) a lane and tile; a lane moves 33 B.
//
// Design (common.cuh): one thread per lane, 256-lane blocks.
// - The list build (trt_block_list_ordered): each alive lane slab-tests
//   its ray against the tile boxes, staged in shared memory, with the
//   reciprocal of its direction taken once (trt_ray), not once a box. A
//   warp first tests the boxes of groups of 32 tiles (trt_group_boxes),
//   and the tiles of a group only where a lane may meet the group's box,
//   which leaves the list as it is. A warp that reaches a tile folds its
//   lanes' least entry distance into the tile's 64-bit (entry, id) key
//   with a shared atomicMin, and a bitonic sort of the keys lists the
//   reached tiles front to back. No thread compacts alone.
// - The fold (trt_fold_tiles_ordered): the block stages the listed tiles
//   in that order through shared memory, every thread reading the same
//   triangle at once. A lane needs a tile only where its ray enters the
//   tile's box at no more than its best t; the block stages only tiles a
//   lane needs and stops once no lane can find a nearer hit in the tiles
//   left. A tile that few lanes of a warp need is tested by the whole
//   warp, 32 triangles at a time, for each of them in turn
//   (trt_fold_tile_warp). The winner is compared by (t, id), so it is the
//   ascending fold's: the lowest id wins an exact tie.
//
// Shared memory: the ordered list (8 B an entry, a power of two >= the
// tiles: 16 KB for bigmesh's 1,281), one staged tile (9 * block_m floats),
// the group boxes (6 floats a group of 32 tiles) and, where they fit, the
// boxes (6 * n_tiles floats; 52 KB in all for bigmesh). Past
// TRT_MAX_SMEM_BYTES the boxes are read from global memory; past it
// without them the launch is refused.
#include "common.cuh"

#define TRT_STREAM_THREADS 256

namespace {

// stats (nullptr, or 3 u64 added to): listed tiles summed over the live
// blocks, live blocks, ray-triangle pairs tested. lists_only: build the
// lists and stop (every lane misses), to time the build alone.
__global__ void tri_stream_kernel(const float* __restrict__ tri, int m,
                                  const float* __restrict__ boxes,
                                  int n_tiles, int block_m, int stage_boxes,
                                  const float* __restrict__ origin,
                                  const float* __restrict__ direction,
                                  const unsigned char* __restrict__ alive,
                                  int r, float* __restrict__ t_out,
                                  int* __restrict__ idx_out, int lists_only,
                                  unsigned long long* __restrict__ stats) {
  extern __shared__ unsigned long long ord[];
  float* tile = reinterpret_cast<float*>(ord + trt_pow2_at_least(n_tiles));
  float* gbox = tile + 9 * block_m;
  float* box = gbox + 6 * ((n_tiles + 31) >> 5);
  __shared__ int s_cnt;
  __shared__ unsigned s_wmax[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool act = false;
  if (in) {
    ox = origin[3 * i]; oy = origin[3 * i + 1]; oz = origin[3 * i + 2];
    dx = direction[3 * i]; dy = direction[3 * i + 1];
    dz = direction[3 * i + 2];
    act = alive == nullptr || alive[i] != 0;
  }
  float best = TRT_F32_MAX;
  int bi = 0;
  int tested = 0;
  // the branch is taken by the whole block, so every barrier and warp vote
  // below is reached by all its threads
  if (__syncthreads_or(act)) {
    const float* bx = boxes;
    if (stage_boxes) {
      for (int k = threadIdx.x; k < 6 * n_tiles; k += blockDim.x) {
        box[k] = boxes[k];
      }
      __syncthreads();
      bx = box;
    }
    trt_group_boxes(bx, n_tiles, gbox);
    const TrtRay ray = trt_ray(ox, oy, oz, dx, dy, dz);
    const int cnt = trt_block_list_ordered(act, ray, bx, gbox, n_tiles, ord,
                                           &s_cnt);
    if (stats && threadIdx.x == 0) {
      atomicAdd(stats, (unsigned long long)cnt);
      atomicAdd(stats + 1, 1ull);
    }
    if (!lists_only) {
      trt_fold_tiles_ordered(tri, m, block_m, ord, cnt, bx, tile, s_wmax, 0,
                             act, ray, best, bi, tested);
    }
  }
  if (stats) {
    const unsigned pairs = __reduce_add_sync(
        0xffffffffu, (unsigned)tested);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats + 2, (unsigned long long)pairs);
    }
  }
  if (in) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
}

}  // namespace

// tri [m, 9] v0|e1|e2; boxes [n_tiles, 6] inflated tile boxes (lo, hi),
// tile t holding triangles [t * m / n_tiles, (t + 1) * m / n_tiles);
// origin, direction [r, 3]; alive [r] u8 or nullptr (every lane alive);
// t_out [r] f32, idx_out [r] i32; lists_only and stats: see the kernel.
extern "C" int trt_tri_stream(const float* tri, int m, const float* boxes,
                              int n_tiles, const float* origin,
                              const float* direction,
                              const unsigned char* alive, int r,
                              float* t_out, int* idx_out, int lists_only,
                              unsigned long long* stats,
                              cudaStream_t stream) {
  if (m < 1 || n_tiles < 1 || m % n_tiles) return (int)cudaErrorInvalidValue;
  const int block_m = m / n_tiles;
  const size_t lists = (size_t)trt_pow2_at_least(n_tiles) * 8 +
                       ((size_t)9 * block_m + 6 * ((n_tiles + 31) / 32)) * 4;
  const size_t with_boxes = lists + (size_t)6 * n_tiles * 4;
  const int stage_boxes = with_boxes <= TRT_MAX_SMEM_BYTES;
  const size_t smem = stage_boxes ? with_boxes : lists;
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(tri_stream_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  const int blocks = (r + TRT_STREAM_THREADS - 1) / TRT_STREAM_THREADS;
  tri_stream_kernel<<<blocks, TRT_STREAM_THREADS, smem, stream>>>(
      tri, m, boxes, n_tiles, block_m, stage_boxes, origin, direction,
      alive, r, t_out, idx_out, lists_only, stats);
  return (int)cudaGetLastError();
}
