// K3: the regen backward, the reverse of a whole recorded trace.
//
// Replaces tpu_ray/kernels/regen.py::regen_seg_bwd (_regen_seg_kernel,
// pallas_call at :967; body :493-719, its triangle branch at :618 and
// :660). The plain version is kernels/regen.py regen_bwd_plain (shading
// transpose: kernels/bounce_step.py shade_vjp_plain, here shade.cuh
// trt_shade_vjp, shared with K6); this file repeats its f32 op sequence,
// branch-free like it, so d_state agrees exactly (see common.cuh on
// -fmad=false).
//
// Inputs: the records of K2's recording mode (regen.cu): rec [steps, r]
// i16 winner ids, chk [ceil(steps/seg), 24, r] checkpoints, t_end [r];
// the cotangent of the final state in dst [24, r] (rows 0-11 and 16-18
// read); the [n, 12] winner table, whose last n_tri rows are triangles.
// Outputs: dst becomes the cotangent of the state before step 0 (rows
// 12-15 and 19-23 zero); d_table [n, 12] and d_cam [12].
//
// Design. d_table and d_cam must be the same from run to run, so no float
// atomics (the scheme of K6, bounce.cu). Launch 1 runs a bounded number of
// blocks (bwd_config); block k owns the lane tiles k, k + grid, ... (a
// partition fixed by r and the table's size, never by the device) and, for
// each tile, walks the segments from the last to the first: each lane
// loads its checkpoint and replays its alive steps of the segment without
// search through trt_step_tail (regen_step.cuh, the forward's own code, so
// the replayed states are the forward's bit for bit), stashing the 12 rows
// the transpose reads (48 B a step, in local memory); then the whole block
// sweeps the segment's steps together from the tile's largest t_end down,
// a lane past its own t_end masked. Each step's d_winner goes into the
// block's [n, 12] partial row in the fixed order of shade.cuh (within a
// warp the lanes of one winner summed by their lowest lane, the warps'
// sums added in warp order; bounce_step.table_sum_fixed_order is its plain
// version). Where the row fits shared memory (rtweekend: 24.6 KB) a block
// is two warps that take turns on it (trt_row_turns): two barriers a step
// couple only those two, eight blocks an SM hold their rows (with the
// carveout set to shared memory) and 16 warps, at 128 registers a thread.
// (Blocks of one warp, with no barrier but 8 warps an SM, and 256-thread
// blocks of eight barriers a step are slower: tools/cull_variants.py
// times them from patched copies, PERF.md.) Where it does not (every
// triangle scene; trimesh: 10,496 x 48 B) the row is the block's own row
// of the partials in global memory, which no other block touches, and a
// step makes one merge (trt_row_merge): the warps stage their keyed sums
// in shared memory, and after one barrier the thread of each winner's
// lowest warp reads the row entry, adds the warps' sums in warp order and
// writes it back, every winner at once, where eight warps taking turns
// made eight dependent round trips to L2 or DRAM a step. A bitmap of n
// bits in shared memory marks the rows the block has touched: a first
// touch writes without reading, so the partials are never cleared, and
// the block writes its bitmap out at the end. These blocks are 256
// threads, two an SM (16 warps, at 128 registers a thread), 256 of them at
// most: the turns' partition, so d_table is theirs bit for bit; smaller
// blocks in more parts were no faster (tools/bwd_turns.py times them,
// PERF.md). The 12 camera-row cotangents
// accumulate per lane in registers and are summed over the block's
// threads in thread order at the end. Launch 2 (shade.cuh trt_sum_parts)
// sums the partials over the blocks in order from +0.0, one thread per
// entry; in the global-row branch only the blocks whose bit of the row is
// set, which gives the same bits as adding the others' zeros. The
// cotangent of a lane stays in registers across its segments; the TPU
// kernel's per-segment launch and HBM round trip of d_state are gone.
// The table is read from global memory through L1/L2.
//
// Bound on the H100: fp32 ALU (replay ~200 flops and transpose ~500 flops
// a lane-step, no search), against 2 B of record, 48 B of stash written
// and read, and 96 B of checkpoint every seg steps.
#include "regen_step.cuh"

#define TRT_SEG_MAX 64
#define TRT_STASH 12
// the global-row branch: its block shape, the most blocks (parts) and the
// blocks an SM should hold
#define TRT_BWD_THREADS 256
#define TRT_BWD_PARTS 256
#define TRT_BWD_BLOCKS 2
// the shared-row branch: blocks of two warps, at most 1,024 of them, and
// eight blocks an SM where registers and shared memory allow
#define TRT_BWD_SMEM_THREADS 64
#define TRT_BWD_SMEM_PARTS 1024
#define TRT_BWD_SMEM_BLOCKS 8
// the largest partial row kept in shared memory
#define TRT_BWD_SMEM_ROW (96 * 1024)

namespace {

// Dynamic shared memory: with SMEM_ROW, 13 floats a thread of staged
// d_winner, then the [n, 12] partial row; else the merge's scratch
// (shade.cuh trt_row_merge_at), the row being the block's row of part.
// THREADS and MIN_BLOCKS: the block size it is launched with and the
// blocks an SM should hold (__launch_bounds__). touched and stats: the
// global-row branch's bitmaps and counts (trt_row_merge_end).
template <int THREADS, int MIN_BLOCKS, bool SMEM_ROW>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
regen_bwd_kernel(float* __restrict__ dst, int r,
                                 const float* __restrict__ cam13,
                                 const float* __restrict__ table, int n,
                                 int n_tri, const int16_t* __restrict__ rec,
                                 const float* __restrict__ chk,
                                 const int* __restrict__ t_end, int steps,
                                 int seg, TrtRegenParams p,
                                 float* __restrict__ part,
                                 unsigned* __restrict__ touched,
                                 float* __restrict__ part_cam,
                                 unsigned long long* stats) {
  extern __shared__ float smem[];
  __shared__ int s_tmax;
  float* sdw = smem;
  float* acc = smem + 13 * THREADS;
  float* row = part + (size_t)blockIdx.x * 12 * n;
  const TrtRowMerge mg = trt_row_merge_at(smem, THREADS);
  unsigned counts[4] = {0u, 0u, 0u, 0u};
  if (SMEM_ROW) {
    for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) acc[k] = 0.0f;
  } else {
    trt_row_merge_begin(mg, n);
  }
  __syncthreads();

  const TrtCam c = trt_load_cam(cam13);
  const bool has_tris = n_tri > 0;
  const int n_sph = n - n_tri;
  const int n_tiles = (r + blockDim.x - 1) / blockDim.x;
  const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
  const float s_01 = 2.3283064365386963e-10f;   // 2^-32
  float dcam[12];
  for (int k = 0; k < 12; ++k) dcam[k] = 0.0f;
  float stash[TRT_SEG_MAX * TRT_STASH];

  // every loop bound below is the same for all threads of the block, so
  // each __syncthreads and __match_any_sync is reached by all of them
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * blockDim.x + threadIdx.x;
    const bool in = i < r;
    const int te = in ? min(t_end[i], steps) : 0;
    if (threadIdx.x == 0) s_tmax = 0;
    __syncthreads();
    atomicMax(&s_tmax, te);
    __syncthreads();
    const int tmax = s_tmax;

    float g[12], g_tot[3];
    for (int k = 0; k < 12; ++k) g[k] = in ? dst[(size_t)k * r + i] : 0.0f;
    for (int k = 0; k < 3; ++k) {
      g_tot[k] = in ? dst[(size_t)(16 + k) * r + i] : 0.0f;
    }
    TrtLane L = {};

    for (int s = tmax > 0 ? (tmax - 1) / seg : -1; s >= 0; --s) {
      const int t0 = s * seg;
      const int t1 = min(t0 + seg, tmax);
      if (te > t0) {
        // replay the lane's alive steps of the segment, stashing the
        // pre-step rows
        L = trt_load_lane(chk + (size_t)s * 24 * r, r, i);
        const int t1l = min(t0 + seg, te);
        for (int t = t0; t < t1l; ++t) {
          float* q = stash + (t - t0) * TRT_STASH;
          q[0] = L.ox; q[1] = L.oy; q[2] = L.oz;
          q[3] = L.dx; q[4] = L.dy; q[5] = L.dz;
          q[6] = L.ar; q[7] = L.ag; q[8] = L.ab;
          q[9] = __uint_as_float(L.base); q[10] = L.s_i; q[11] = L.b_i;
          trt_step_tail(L, c, table, rec[(size_t)t * r + i], p);
        }
      }
      // sweep back through the step transposes, the block together
      for (int t = t1 - 1; t >= t0; --t) {
        int key = -1;
        float d_w[12];
        for (int k = 0; k < 12; ++k) d_w[k] = 0.0f;
        if (t < te) {
          const float* q = stash + (t - t0) * TRT_STASH;
          const int idx = rec[(size_t)t * r + i];
          const bool live = idx >= 0;
          const uint32_t base = __float_as_uint(q[9]);
          const float s_i = q[10], b_i = q[11];
          const float b_next = b_i + 1.0f;
          const bool finished = !(live && b_next < (float)p.max_bounces);
          const float s_next = s_i + (finished ? 1.0f : 0.0f);
          const bool has_more = finished && s_next < c.s_end;

          float g16[12];
          for (int k = 0; k < 9; ++k) g16[k] = has_more ? 0.0f : g[k];
          for (int k = 0; k < 3; ++k) {
            g16[9 + k] = finished ? g_tot[k] : g[9 + k];
          }
          const uint32_t bterm = (uint32_t)b_i * TRT_MIX_BOUNCE;
          const float rd0 = trt_draw(base, bterm, 0u, s_pm1, -1.0f);
          const float rd1 = trt_draw(base, bterm, 1u, s_pm1, -1.0f);
          const float rd2 = trt_draw(base, bterm, 2u, s_pm1, -1.0f);
          const float rrefl = trt_draw(base, bterm, 3u, s_01, 0.0f);
          const float* w = table + 12 * (size_t)(live ? idx : 0);
          float d_s[9];
          trt_shade_vjp(q, w, live, !live, rd0, rd1, rd2, rrefl,
                        p.use_sky != 0, g16, d_s, d_w, has_tris,
                        idx >= n_sph);

          // the regenerated direction d3 = normalize_eps(fc + fx cam_x +
          // fy cam_y - pos): its camera cotangent
          const uint32_t nbase =
              trt_pcg_hash(L.h1 + (uint32_t)(int)s_next * TRT_MIX_SAMPLE);
          float fx, fy, rx, ry, rz, nx, ny, nz, inv, drx, dry, drz;
          bool ok;
          trt_film_offsets(L.ax, L.ay, nbase, p, fx, fy);
          trt_film_vec(c, fx, fy, rx, ry, rz);
          trt_nrm3_fwd(rx, ry, rz, nx, ny, nz, inv, ok);
          trt_nrm3_bwd(nx, ny, nz, inv, ok, has_more ? g[3] : 0.0f,
                       has_more ? g[4] : 0.0f, has_more ? g[5] : 0.0f, drx,
                       dry, drz);
          const float dr[3] = {drx, dry, drz};
          for (int k = 0; k < 3; ++k) {
            dcam[k] = dcam[k] + ((has_more ? g[k] : 0.0f) - dr[k]);
            dcam[3 + k] = dcam[3 + k] + dr[k];
            dcam[6 + k] = dcam[6 + k] + fx * dr[k];
            dcam[9 + k] = dcam[9 + k] + fy * dr[k];
          }
          for (int k = 0; k < 9; ++k) g[k] = d_s[k];
          for (int k = 0; k < 3; ++k) g[9 + k] = g16[9 + k];
          if (live) key = idx;
        }
        // d_table of this step, in the fixed order (shade.cuh)
        if (SMEM_ROW) {
          trt_row_turns(sdw, key, d_w, acc);
        } else {
          trt_row_merge(mg, key, d_w, row, counts);
        }
      }
    }
    if (in) {
      for (int k = 0; k < 24; ++k) {
        float v = 0.0f;
        if (k < 12) v = g[k];
        else if (k >= 16 && k < 19) v = g_tot[k - 16];
        dst[(size_t)k * r + i] = v;
      }
    }
  }
  // the block's camera cotangents, summed over its threads in order (in
  // the global-row branch once every thread has read the last merge's
  // slots)
  if (!SMEM_ROW) __syncthreads();
  for (int k = 0; k < 12; ++k) sdw[threadIdx.x * 13 + k] = dcam[k];
  __syncthreads();
  if (threadIdx.x < 12) {
    float v = 0.0f;
    for (int j = 0; j < (int)blockDim.x; ++j) v = v + sdw[j * 13 + threadIdx.x];
    part_cam[(size_t)blockIdx.x * 12 + threadIdx.x] = v;
  }
  if (SMEM_ROW) {
    for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) row[k] = acc[k];
  } else {
    trt_row_merge_end(mg, n, touched, stats, counts);
  }
}

// K3's configuration for a table of n rows. Where the [n, 12] row fits
// TRT_BWD_SMEM_ROW: blocks of two warps, each block's partial row in
// shared memory. Else the global-row branch: each block's row in its own
// row of the partials, one merge a step (shade.cuh trt_row_merge).
struct TrtBwdConfig {
  bool smem_row;
  int threads, max_parts;
  size_t smem;
};

TrtBwdConfig bwd_config(int n) {
  const size_t row = (size_t)12 * n * sizeof(float);
  if (row > TRT_BWD_SMEM_ROW) {
    return {false, TRT_BWD_THREADS, TRT_BWD_PARTS,
            trt_row_merge_bytes(TRT_BWD_THREADS, n)};
  }
  return {true, TRT_BWD_SMEM_THREADS, TRT_BWD_SMEM_PARTS,
          (size_t)13 * TRT_BWD_SMEM_THREADS * sizeof(float) + row};
}

int bwd_parts(const TrtBwdConfig& cfg, int r) {
  const int blocks = (r + cfg.threads - 1) / cfg.threads;
  return blocks < cfg.max_parts ? blocks : cfg.max_parts;
}

// The kernel of a configuration, its attributes set (shared memory, and
// the carveout that lets TRT_BWD_SMEM_BLOCKS small blocks hold their
// rows).
cudaError_t bwd_kernel(const TrtBwdConfig& cfg, const void** fn) {
  if (cfg.smem > TRT_MAX_SMEM_BYTES) return cudaErrorInvalidValue;
  const void* k =
      cfg.smem_row
          ? (const void*)regen_bwd_kernel<TRT_BWD_SMEM_THREADS,
                                          TRT_BWD_SMEM_BLOCKS, true>
          : (const void*)regen_bwd_kernel<TRT_BWD_THREADS, TRT_BWD_BLOCKS,
                                          false>;
  *fn = k;
  cudaError_t err = trt_set_smem(k, cfg.smem);
  if (err == cudaSuccess && cfg.smem_row) {
    err = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

}  // namespace

// The number of K3 partial rows for r lanes and a table of n rows (the
// wrapper sizes them): a function of those alone, never of the device, so
// the partition of the lanes, and with it the sums, is the same on every
// card.
extern "C" int trt_regen_bwd_parts(int r, int n) {
  return bwd_parts(bwd_config(n), r);
}

// K3's launch-1 kernel for a table of n rows, as the card runs it: out[0] registers a thread, out[1] local memory a thread
// (bytes: the stash and any spills), out[2] blocks an SM holds (the
// occupancy calculator), out[3] threads a block, out[4] dynamic shared
// memory a block (bytes), out[5] the SMs. -> a CUDA error code.
extern "C" int trt_regen_bwd_info(int n, int* out) {
  const TrtBwdConfig cfg = bwd_config(n);
  const void* fn = nullptr;
  cudaError_t err = bwd_kernel(cfg, &fn);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      cfg.threads, cfg.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = cfg.threads;
  out[4] = (int)cfg.smem;
  out[5] = sms;
  return (int)err;
}

// dstate [24, r] (d_out in, d_state out); table [n, 12], its last n_tri
// rows triangles; part [trt_regen_bwd_parts(r, n), n, 12], touched
// [trt_regen_bwd_parts(r, n), ceil(n / 32)] u32 and part_cam
// [trt_regen_bwd_parts(r, n), 12] scratch, never cleared; d_table [n, 12]
// and d_cam [12] out; stats nullptr or u64 [5], added to where the row is
// in global memory (shade.cuh trt_row_merge_end).
extern "C" int trt_regen_bwd(float* dstate, int r, const float* cam13,
                             const float* table, int n, int n_tri,
                             const int16_t* rec, const float* chk,
                             const int* t_end, int steps, int seg,
                             int use_sky, int max_bounces, int width,
                             int height, float film_w, float film_h,
                             float* part, unsigned* touched, float* part_cam,
                             float* d_table, float* d_cam,
                             unsigned long long* stats,
                             cudaStream_t stream) {
  if (seg < 1 || seg > TRT_SEG_MAX) return (int)cudaErrorInvalidValue;
  if (n_tri < 0 || n_tri > n) return (int)cudaErrorInvalidValue;
  const TrtBwdConfig cfg = bwd_config(n);
  const void* fn = nullptr;
  cudaError_t err = bwd_kernel(cfg, &fn);
  if (err != cudaSuccess) return (int)err;
  TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                   film_w, film_h, n - n_tri};
  int parts = 0;
  if (r > 0) {
    parts = bwd_parts(cfg, r);
    void* args[] = {&dstate, &r, &cam13, &table, &n, &n_tri, &rec, &chk,
                    &t_end, &steps, &seg, &p, &part, &touched, &part_cam,
                    &stats};
    err = cudaLaunchKernel(fn, dim3(parts), dim3(cfg.threads), args,
                           cfg.smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  trt_sum_parts_launch(part, cfg.smem_row ? nullptr : touched,
                       (n + 31) / 32, parts, 12 * n, d_table, stream);
  trt_sum_parts_launch(part_cam, nullptr, 1, parts, 12, d_cam, stream);
  return (int)cudaGetLastError();
}
