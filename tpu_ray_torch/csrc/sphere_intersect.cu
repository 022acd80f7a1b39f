// K1: nearest sphere hit per ray.
//
// Replaces tpu_ray/kernels/sphere_intersect.py::nearest_hit_pallas
// (_kernel_packed / _kernel_exact, pallas_call at :204). Contract:
// ops/intersect.py nearest_hit, the exact projection form: t > 1e-4, the
// far root when the near root is behind the origin, radius-0 padding never
// hits, the lowest index wins a tie, a miss gives t = 1e30 and idx = 0.
// The TPU kernel's bf16x6 K-stacked matmul roots and packed (t|idx) argmin
// are not carried over: an H100 thread does the f32 chain directly, in the
// plain version's op order (-fmad=false), so the two agree bit for bit.
//
// Bound on the H100: fp32 ALU where the table holds many real spheres
// (each ray-sphere pair ~20 flops and one sqrt on a hit, against 32 B of
// device memory a ray: rtweekend's 482 spheres are ~10^4 flops a ray), the
// rays' bytes where it holds few (bigmesh, trimesh and trilight pad one
// glass sphere to 128 slots). Built with -fmad=false, the sweep can reach
// at most half of the fp32 bound priced at 67 TFLOP/s.
//
// Design, against that bound:
// - Only the slots that can hit are folded. A slot whose r * r is not > 0
//   in f32 (zero radius, a square that underflows, NaN) fails dsq < r^2
//   for every ray. Each block counts the real slots (each thread its
//   slots, then one sum over the warps) and stages its share of them in
//   ascending slot order, each with its own id (a warp ballot and the
//   warps' counts give each real slot of 128 its place, one barrier a
//   128 slots, the next 128 radii loading meanwhile; then the placed
//   slots' centres are read at once), so padding anywhere in the table is
//   skipped exactly, in the launch, with no host sync. The staged entry
//   holds r * r, the plain version's r2.
// - Several rays a thread (TRT_K1_RAYS), in registers: each staged sphere
//   feeds that many independent test chains for one broadcast float4 read
//   from shared memory. The chains to dsq run branch-free; the roots sit
//   behind one branch for all the rays, taken where a line passes within
//   r of the centre.
// - The real slots are split into slices where the ray blocks alone do
//   not fill the card (trt_sphere_slices, chosen from the padded count,
//   which the host knows; each block slices the real slots it counted),
//   merged per ray by K7's 64-bit (t, id) atomicMin (common.cuh, the
//   sliced search). At one slice the block writes t and idx itself.
// - Tiles of TRT_K1_TILE real spheres are staged between barriers; a
//   table of any size is searched.
#include "common.cuh"

#define TRT_K1_THREADS 128
#define TRT_K1_RAYS 2
#define TRT_K1_BLOCK_RAYS (TRT_K1_THREADS * TRT_K1_RAYS)
#define TRT_K1_WARPS (TRT_K1_THREADS / 32)
// the real spheres a block stages at once
#define TRT_K1_TILE 512
// the grid aims at this many waves of resident blocks
#define TRT_K1_WAVES 3
// the fewest padded slots a slice spans (fewer slices past it): one
// SPHERE_PAD, so a table of one padded block is never split
#define TRT_K1_MIN_SLICE 128

namespace {

// A slot's r * r in f32, the plain version's r2. A slot where it is not
// > 0 (zero, an underflow, NaN) can never hit: dsq < r2 fails on every
// ray.
__device__ __forceinline__ float k1_square(float r) { return r * r; }

// Ray block blockIdx.x (rays blockIdx.x * TRT_K1_BLOCK_RAYS + k *
// TRT_K1_THREADS + threadIdx.x, k < TRT_K1_RAYS) against slice blockIdx.y
// of the real slots, taken in ascending slot order. SPLIT: merge into keys
// (atomicMin); else write t_out and idx_out.
template <bool SPLIT>
__global__ void __launch_bounds__(TRT_K1_THREADS)
sphere_nearest_hit_kernel(const float* __restrict__ center,
                          const float* __restrict__ radius, int n,
                          const float* __restrict__ origin,
                          const float* __restrict__ direction, int r,
                          float* __restrict__ t_out,
                          int* __restrict__ idx_out,
                          unsigned long long* __restrict__ keys) {
  __shared__ float4 sph[TRT_K1_TILE];       // cx, cy, cz, r2
  __shared__ int ids[TRT_K1_TILE];
  __shared__ int wcount[2][TRT_K1_WARPS];   // taken in turn by the scans
  // the rays first: their loads are in flight while the table is read
  const int i0 = blockIdx.x * TRT_K1_BLOCK_RAYS + threadIdx.x;
  float ox[TRT_K1_RAYS], oy[TRT_K1_RAYS], oz[TRT_K1_RAYS];
  float dx[TRT_K1_RAYS], dy[TRT_K1_RAYS], dz[TRT_K1_RAYS];
  float best[TRT_K1_RAYS];
  int bi[TRT_K1_RAYS];
#pragma unroll
  for (int k = 0; k < TRT_K1_RAYS; ++k) {
    const int i = i0 + k * TRT_K1_THREADS;
    ox[k] = oy[k] = oz[k] = dx[k] = dy[k] = dz[k] = 0.0f;
    if (i < r) {                 // a ray past r is folded but not written
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
  // the real slots, counted; this block's slice of them [b0, b1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mine = 0;          // each thread's slots, their loads in flight at once
#pragma unroll 4
  for (int j = threadIdx.x; j < n; j += TRT_K1_THREADS) {
    mine += k1_square(radius[j]) > 0.0f;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (lane == 0) wcount[0][warp] = mine;
  __syncthreads();
  int c = 0;
#pragma unroll
  for (int w = 0; w < TRT_K1_WARPS; ++w) c += wcount[0][w];
  const int per = (c + gridDim.y - 1) / gridDim.y;
  const int b0 = min(c, (int)blockIdx.y * per), b1 = min(c, b0 + per);
  // the scan: the next 128 slots to read and the real slots before them,
  // both the same in every thread (it writes wcount past the first tile's
  // barrier, when every warp has summed the counts)
  int j0 = 0, before = 0, turn = 0;
  float rad = threadIdx.x < n ? radius[threadIdx.x] : 0.0f;
  for (int lo = b0; lo < b1; lo += TRT_K1_TILE) {
    const int hi = min(b1, lo + TRT_K1_TILE);
    __syncthreads();     // every thread is done with the previous tile
    // place the real slots of places [lo, hi): their ids and r2
    while (j0 < n && before < hi) {
      const int j = j0 + threadIdx.x;
      const int j_next = j + TRT_K1_THREADS;
      // the next 128 radii load while these are placed
      const float rad_next = j_next < n ? radius[j_next] : 0.0f;
      const float r2 = k1_square(rad);
      const bool real = j < n && r2 > 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, real);
      if (lane == 0) wcount[turn][warp] = __popc(mask);
      __syncthreads();
      int place = before + __popc(mask & ((1u << lane) - 1u));
      int total = 0;
#pragma unroll
      for (int w = 0; w < TRT_K1_WARPS; ++w) {
        const int cw = wcount[turn][w];
        place += w < warp ? cw : 0;
        total += cw;
      }
      // the next scan writes the other buffer: a warp can only come back
      // to this one past the next scan's barrier, when every warp has
      // read it
      turn ^= 1;
      if (real && place >= lo && place < hi) {
        sph[place - lo].w = r2;
        ids[place - lo] = j;
      }
      // slots past this tile: read these 128 again for the next one
      if (before + total > hi) break;
      before += total;
      j0 += TRT_K1_THREADS;
      rad = rad_next;
    }
    __syncthreads();
    // the placed slots' centres, their loads in flight at once
    for (int q = threadIdx.x; q < hi - lo; q += TRT_K1_THREADS) {
      const size_t k = 3 * (size_t)ids[q];
      sph[q].x = center[k];
      sph[q].y = center[k + 1];
      sph[q].z = center[k + 2];
    }
    __syncthreads();
    // ops/intersect.py nearest_hit over the tile, in ascending id, strict <
    const int cnt = hi - lo;
    for (int q = 0; q < cnt; ++q) {
      const float4 s = sph[q];
      // every ray's distance to the centre first, in one block of code
      // the compiler interleaves; the roots only where a ray's line passes
      // within r, behind one branch for all of them (few pairs take it)
      float tp[TRT_K1_RAYS], dsq[TRT_K1_RAYS];
      bool near = false;
#pragma unroll
      for (int k = 0; k < TRT_K1_RAYS; ++k) {
        const float mx = s.x - ox[k], my = s.y - oy[k], mz = s.z - oz[k];
        tp[k] = mx * dx[k] + my * dy[k] + mz * dz[k];
        const float px = mx - dx[k] * tp[k], py = my - dy[k] * tp[k],
                    pz = mz - dz[k] * tp[k];
        dsq[k] = px * px + py * py + pz * pz;
        near |= dsq[k] < s.w;
      }
      if (!near) continue;
#pragma unroll
      for (int k = 0; k < TRT_K1_RAYS; ++k) {
        if (dsq[k] < s.w) {
          const float x = trt_safe_sqrt(s.w - dsq[k]);
          const float tn = tp[k] - x;
          const float t = tn < TRT_F32_EPS ? tp[k] + x : tn;
          if (t > TRT_F32_EPS && t < best[k]) {
            best[k] = t;
            bi[k] = ids[q];
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TRT_K1_RAYS; ++k) {
    const int i = i0 + k * TRT_K1_THREADS;
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

// The resident blocks of sphere_nearest_hit_kernel a wave holds on each
// device (trt_wave_of).
static int trt_k1_wave[TRT_MAX_DEVICES];

// The slices of a launch of r rays over a table of n slots on the current
// device -> at least 1; 1 where the ray blocks alone make TRT_K1_WAVES
// waves of resident blocks, else enough slices for that many blocks, each
// spanning at least TRT_K1_MIN_SLICE slots. A negative return is a CUDA
// error.
extern "C" int trt_sphere_slices(int r, int n) {
  const int wave = trt_wave_of(sphere_nearest_hit_kernel<true>,
                               TRT_K1_THREADS, trt_k1_wave);
  if (wave < 0) return wave;
  return trt_search_slices(r, n, TRT_K1_BLOCK_RAYS, TRT_K1_MIN_SLICE,
                           TRT_K1_WAVES, wave);
}

// center [n, 3], radius [n]; origin, direction [r, 3]; slices >= 1 (the
// real slots split in that many ascending slices); keys [r] u64 scratch,
// needed when slices > 1; t_out [r] f32, idx_out [r] i32.
extern "C" int trt_sphere_nearest_hit(const float* center,
                                      const float* radius, int n,
                                      const float* origin,
                                      const float* direction, int r,
                                      int slices, unsigned long long* keys,
                                      float* t_out, int* idx_out,
                                      cudaStream_t stream) {
  if (n < 0 || r < 0 || slices < 1 || slices > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (r == 0) return 0;    // an empty keys tensor has no pointer
  if (slices > 1 && keys == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((r + TRT_K1_BLOCK_RAYS - 1) / TRT_K1_BLOCK_RAYS, slices);
  if (slices == 1) {
    sphere_nearest_hit_kernel<false><<<grid, TRT_K1_THREADS, 0, stream>>>(
        center, radius, n, origin, direction, r, t_out, idx_out, nullptr);
    return (int)cudaGetLastError();
  }
  cudaError_t err = trt_keys_clear(keys, r, stream);
  if (err != cudaSuccess) return (int)err;
  sphere_nearest_hit_kernel<true><<<grid, TRT_K1_THREADS, 0, stream>>>(
      center, radius, n, origin, direction, r, nullptr, nullptr, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)trt_keys_unpack<1>(keys, r, t_out, idx_out, stream);
}
