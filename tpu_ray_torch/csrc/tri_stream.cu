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
// MXU form are TPU mechanism and are not carried over: as K8 and K9 do,
// each block builds its own list in the launch (common.cuh trt_block_list:
// slab tests of its alive lanes against the tile boxes staged in shared
// memory, warp votes, ascending compaction) and folds the listed tiles in
// ascending id, each staged through shared memory and read by every thread
// at once (trt_fold_tiles_staged), with the plain version's f32 op order
// (trt_tri_hit), so kernel and plain version agree bit for bit. A block
// with no alive lane leaves at once.
//
// Shared memory: one staged tile (9 * block_m floats), reach and lst
// (n_tiles ints each) and, where they fit, the boxes (6 * n_tiles floats;
// 46 KB in all for bigmesh's 1,281 tiles). Past TRT_MAX_SMEM_BYTES the
// boxes are read from global memory; past it without them the launch is
// refused.
#include "common.cuh"

#define TRT_STREAM_THREADS 256

namespace {

__global__ void tri_stream_kernel(const float* __restrict__ tri, int m,
                                  const float* __restrict__ boxes,
                                  int n_tiles, int block_m, int stage_boxes,
                                  const float* __restrict__ origin,
                                  const float* __restrict__ direction,
                                  const unsigned char* __restrict__ alive,
                                  int r, float* __restrict__ t_out,
                                  int* __restrict__ idx_out) {
  extern __shared__ float smem[];
  float* tile = smem;
  int* reach = reinterpret_cast<int*>(tile + 9 * block_m);
  int* lst = reach + n_tiles;
  float* box = reinterpret_cast<float*>(lst + n_tiles);
  __shared__ int s_cnt;
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
    const int cnt = trt_block_list(act, ox, oy, oz, dx, dy, dz, bx, n_tiles,
                                   reach, lst, &s_cnt);
    trt_fold_tiles_staged(tri, m, block_m, lst, cnt, tile, 0, act, ox, oy,
                          oz, dx, dy, dz, best, bi);
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
// t_out [r] f32, idx_out [r] i32.
extern "C" int trt_tri_stream(const float* tri, int m, const float* boxes,
                              int n_tiles, const float* origin,
                              const float* direction,
                              const unsigned char* alive, int r,
                              float* t_out, int* idx_out,
                              cudaStream_t stream) {
  if (m < 1 || n_tiles < 1 || m % n_tiles) return (int)cudaErrorInvalidValue;
  const int block_m = m / n_tiles;
  const size_t lists = ((size_t)9 * block_m + 2 * (size_t)n_tiles) * 4;
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
      alive, r, t_out, idx_out);
  return (int)cudaGetLastError();
}
