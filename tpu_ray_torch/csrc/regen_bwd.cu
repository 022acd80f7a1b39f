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
// blocks (at most TRT_BWD_PARTS); block k owns the lane tiles k, k + grid,
// ... (a partition fixed by r alone) and, for each tile, walks the
// segments from the last to the first: each lane loads its checkpoint and
// replays its alive steps of the segment without search through
// trt_step_tail (regen_step.cuh, the forward's own code, so the replayed
// states are the forward's bit for bit), stashing the 12 rows the
// transpose reads (48 B a step, in local memory); then the whole block
// sweeps the segment's steps together from the tile's largest t_end
// down, a lane past its own t_end masked. At each step, within a warp the
// lanes of one winner (__match_any_sync) are summed by their lowest lane
// in lane order, and the warps add their sums to the block's partial row
// [n, 12] one warp at a time. The row sits in shared memory when it fits
// (rtweekend: 24.6 KB; there K3 took 59 ms against 66 ms with the global
// row, chip_smoke.py on an H100 80GB HBM3 at 700 W) and otherwise in the
// block's own row of the partials in global memory (trimesh: 10,496 x
// 48 B), which no other block touches. The 12 camera-row cotangents accumulate per lane in
// registers and are summed over the block's threads in thread order at
// the end. Launch 2 sums the partials over the blocks in order, one
// thread per entry. The cotangent of a lane stays in registers across
// its segments; the TPU kernel's per-segment launch and HBM round trip of
// d_state are gone. The table is read from global memory through L1/L2.
//
// Bound on the H100: fp32 ALU (replay ~200 flops and transpose ~500 flops
// a lane-step, no search), against 2 B of record, 48 B of stash written
// and read, and 96 B of checkpoint every seg steps.
#include "regen_step.cuh"

#define TRT_SEG_MAX 64
#define TRT_STASH 12
#define TRT_BWD_THREADS 256
// the most blocks of launch 1 (the partials' leading dimension)
#define TRT_BWD_PARTS 256
// the largest partial row kept in shared memory
#define TRT_BWD_SMEM_ROW (96 * 1024)

namespace {

// Dynamic shared memory: 13 floats a thread of staged d_winner (13, not
// 12, so consecutive threads start in different banks), then the [n, 12]
// partial row when smem_row is set.
__global__ void regen_bwd_kernel(float* __restrict__ dst, int r,
                                 const float* __restrict__ cam13,
                                 const float* __restrict__ table, int n,
                                 int n_tri, const int16_t* __restrict__ rec,
                                 const float* __restrict__ chk,
                                 const int* __restrict__ t_end, int steps,
                                 int seg, TrtRegenParams p, int smem_row,
                                 float* __restrict__ part,
                                 float* __restrict__ part_cam) {
  extern __shared__ float smem[];
  __shared__ int s_tmax;
  float* sdw = smem;
  float* acc = smem_row ? smem + 13 * blockDim.x
                        : part + (size_t)blockIdx.x * 12 * n;
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();

  const TrtCam c = trt_load_cam(cam13);
  const bool has_tris = n_tri > 0;
  const int n_sph = n - n_tri;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
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
        // d_table of this step, in a fixed order: the lanes of one winner
        // summed by their lowest lane, the warps one at a time
        for (int k = 0; k < 12; ++k) sdw[threadIdx.x * 13 + k] = d_w[k];
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        __syncwarp();
        const bool leader = key >= 0 && lane == __ffs(peers) - 1;
        float sum[12];
        if (leader) {
          for (int k = 0; k < 12; ++k) sum[k] = 0.0f;
          for (unsigned mk = peers; mk; mk &= mk - 1) {
            const float* v = sdw + (warp * 32 + __ffs(mk) - 1) * 13;
            for (int k = 0; k < 12; ++k) sum[k] = sum[k] + v[k];
          }
        }
        for (int wp = 0; wp < n_warps; ++wp) {
          if (warp == wp && leader) {
            for (int k = 0; k < 12; ++k) {
              acc[12 * key + k] = acc[12 * key + k] + sum[k];
            }
          }
          __syncthreads();
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
  // the block's camera cotangents, summed over its threads in order
  for (int k = 0; k < 12; ++k) sdw[threadIdx.x * 13 + k] = dcam[k];
  __syncthreads();
  if (threadIdx.x < 12) {
    float v = 0.0f;
    for (int j = 0; j < (int)blockDim.x; ++j) v = v + sdw[j * 13 + threadIdx.x];
    part_cam[(size_t)blockIdx.x * 12 + threadIdx.x] = v;
  }
  if (smem_row) {
    float* row = part + (size_t)blockIdx.x * 12 * n;
    for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) row[k] = acc[k];
  }
}

// out[j] = sum over k in order of part[k, j], j < m.
__global__ void regen_bwd_sum_kernel(const float* __restrict__ part,
                                     int parts, int m,
                                     float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
  for (int k = 0; k < parts; ++k) s = s + part[(size_t)k * m + j];
  out[j] = s;
}

}  // namespace

// The number of K3 partial rows for r lanes (the wrapper sizes them).
extern "C" int trt_regen_bwd_parts(int r) {
  const int blocks = (r + TRT_BWD_THREADS - 1) / TRT_BWD_THREADS;
  return blocks < TRT_BWD_PARTS ? blocks : TRT_BWD_PARTS;
}

// dstate [24, r] (d_out in, d_state out); table [n, 12], its last n_tri
// rows triangles; part [trt_regen_bwd_parts(r), n, 12] and part_cam
// [trt_regen_bwd_parts(r), 12] scratch; d_table [n, 12] and d_cam [12]
// out.
extern "C" int trt_regen_bwd(float* dstate, int r, const float* cam13,
                             const float* table, int n, int n_tri,
                             const int16_t* rec, const float* chk,
                             const int* t_end, int steps, int seg,
                             int use_sky, int max_bounces, int width,
                             int height, float film_w, float film_h,
                             float* part, float* part_cam, float* d_table,
                             float* d_cam, cudaStream_t stream) {
  if (seg < 1 || seg > TRT_SEG_MAX) return (int)cudaErrorInvalidValue;
  if (n_tri < 0 || n_tri > n) return (int)cudaErrorInvalidValue;
  const size_t row = (size_t)12 * n * sizeof(float);
  const int smem_row = row <= TRT_BWD_SMEM_ROW;
  const size_t smem =
      (size_t)13 * TRT_BWD_THREADS * sizeof(float) + (smem_row ? row : 0);
  cudaError_t err = trt_set_smem(regen_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h, n - n_tri};
  int parts = 0;
  if (r > 0) {
    parts = trt_regen_bwd_parts(r);
    regen_bwd_kernel<<<parts, TRT_BWD_THREADS, smem, stream>>>(
        dstate, r, cam13, table, n, n_tri, rec, chk, t_end, steps, seg, p,
        smem_row, part, part_cam);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int m = 12 * n;
  if (m > 0) {
    regen_bwd_sum_kernel<<<(m + 63) / 64, 64, 0, stream>>>(part, parts, m,
                                                           d_table);
  }
  regen_bwd_sum_kernel<<<1, 64, 0, stream>>>(part_cam, parts, 12, d_cam);
  return (int)cudaGetLastError();
}
