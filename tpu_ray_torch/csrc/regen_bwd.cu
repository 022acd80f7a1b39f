// K3: the regen backward, the reverse of a whole recorded trace in one
// launch.
//
// Replaces tpu_ray/kernels/regen.py::regen_seg_bwd (_regen_seg_kernel,
// pallas_call at :967; body :493-719). The plain version is
// kernels/regen.py regen_bwd_plain (shading transpose:
// kernels/bounce_step.py shade_vjp_plain, here shade.cuh trt_shade_vjp,
// shared with K6); this file repeats its f32 op
// sequence, branch-free like it, so d_state agrees exactly (see common.cuh
// on -fmad=false).
//
// Inputs: the records of K2's recording mode (regen.cu): rec [steps, r]
// i16 winner ids, chk [ceil(steps/seg), 24, r] checkpoints, t_end [r];
// the cotangent of the final state in dst [24, r] (rows 0-11 and 16-18
// read). Outputs: dst becomes the cotangent of the state before step 0
// (rows 12-15 and 19-23 zero); d_table [P,12] and d_cam [12] are ADDED to
// (the caller zeroes them).
//
// Design: one thread per lane, for all of its segments, last to first.
// For each segment it loads the checkpoint, replays the segment's alive
// steps without search through trt_step_tail (regen_step.cuh, the
// forward's own code, so the replayed states are the forward's bit for
// bit), stashing the 12 rows the transpose reads (origin, direction,
// attenuation, rng base, sample, bounce: 48 B a step, in local memory),
// then sweeps back through the hand transpose of the step. The cotangent
// stays in registers across segments, so the TPU kernel's per-segment
// launch and HBM round trip of d_state are gone. The [P,12] table sits in
// shared memory for the replay; d_table accumulates in a shared [P,12]
// block by shared-memory atomics and is added to global memory once per
// block (nonzero entries only); the 12 camera-row cotangents accumulate
// per lane in registers, then by shared and global atomics. The order of
// the atomics varies, so d_table and d_cam vary from run to run in the
// last bits.
//
// Bound on the H100: fp32 ALU (replay ~200 flops and transpose ~500 flops
// a lane-step, no search), against 2 B of record, 48 B of stash written
// and read, and 96 B of checkpoint every seg steps.
#include "regen_step.cuh"

#define TRT_SEG_MAX 64
#define TRT_STASH 12

namespace {

__global__ void regen_bwd_kernel(float* __restrict__ dst, int r,
                                 const float* __restrict__ cam13,
                                 const float* __restrict__ table_g, int n,
                                 const int16_t* __restrict__ rec,
                                 const float* __restrict__ chk,
                                 const int* __restrict__ t_end, int steps,
                                 int seg, TrtRegenParams p,
                                 float* __restrict__ d_table,
                                 float* __restrict__ d_cam_g) {
  extern __shared__ float smem[];
  float* table = smem;             // [n, 12]
  float* dtab = smem + 12 * n;     // [n, 12]
  float* dcam_s = smem + 24 * n;   // [12]
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) {
    table[k] = table_g[k];
    dtab[k] = 0.0f;
  }
  if (threadIdx.x < 12) dcam_s[threadIdx.x] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r) {
    const TrtCam c = trt_load_cam(cam13);
    float g[12], g_tot[3], dcam[12];
    for (int k = 0; k < 12; ++k) {
      g[k] = dst[(size_t)k * r + i];
      dcam[k] = 0.0f;
    }
    for (int k = 0; k < 3; ++k) g_tot[k] = dst[(size_t)(16 + k) * r + i];
    const int te = min(t_end[i], steps);
    float stash[TRT_SEG_MAX * TRT_STASH];
    const float s_pm1 = 4.656612873077393e-10f;   // 2 * 2^-32
    const float s_01 = 2.3283064365386963e-10f;   // 2^-32

    for (int s = te > 0 ? (te - 1) / seg : -1; s >= 0; --s) {
      const int t0 = s * seg;
      const int t1 = min(t0 + seg, te);
      TrtLane L = trt_load_lane(chk + (size_t)s * 24 * r, r, i);
      // replay the segment's alive steps, stashing the pre-step rows
      for (int t = t0; t < t1; ++t) {
        float* q = stash + (t - t0) * TRT_STASH;
        q[0] = L.ox; q[1] = L.oy; q[2] = L.oz;
        q[3] = L.dx; q[4] = L.dy; q[5] = L.dz;
        q[6] = L.ar; q[7] = L.ag; q[8] = L.ab;
        q[9] = __uint_as_float(L.base); q[10] = L.s_i; q[11] = L.b_i;
        trt_step_tail(L, c, table, rec[(size_t)t * r + i], p);
      }
      // sweep back through the step transposes
      for (int t = t1 - 1; t >= t0; --t) {
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
        for (int k = 0; k < 3; ++k) g16[9 + k] = finished ? g_tot[k] : g[9 + k];
        const uint32_t bterm = (uint32_t)b_i * TRT_MIX_BOUNCE;
        const float rd0 = trt_draw(base, bterm, 0u, s_pm1, -1.0f);
        const float rd1 = trt_draw(base, bterm, 1u, s_pm1, -1.0f);
        const float rd2 = trt_draw(base, bterm, 2u, s_pm1, -1.0f);
        const float rrefl = trt_draw(base, bterm, 3u, s_01, 0.0f);
        const float* w = table + 12 * (live ? idx : 0);
        float d_s[9], d_w[12];
        trt_shade_vjp(q, w, live, !live, rd0, rd1, rd2, rrefl, p.use_sky != 0,
                  g16, d_s, d_w);

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
                 has_more ? g[4] : 0.0f, has_more ? g[5] : 0.0f, drx, dry,
                 drz);
        const float dr[3] = {drx, dry, drz};
        for (int k = 0; k < 3; ++k) {
          dcam[k] = dcam[k] + ((has_more ? g[k] : 0.0f) - dr[k]);
          dcam[3 + k] = dcam[3 + k] + dr[k];
          dcam[6 + k] = dcam[6 + k] + fx * dr[k];
          dcam[9 + k] = dcam[9 + k] + fy * dr[k];
        }
        if (live) {
          for (int k = 0; k < 12; ++k) atomicAdd(&dtab[12 * idx + k], d_w[k]);
        }
        for (int k = 0; k < 9; ++k) g[k] = d_s[k];
        for (int k = 0; k < 3; ++k) g[9 + k] = g16[9 + k];
      }
    }
    for (int k = 0; k < 24; ++k) {
      float v = 0.0f;
      if (k < 12) v = g[k];
      else if (k >= 16 && k < 19) v = g_tot[k - 16];
      dst[(size_t)k * r + i] = v;
    }
    for (int k = 0; k < 12; ++k) atomicAdd(&dcam_s[k], dcam[k]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 12 * n; k += blockDim.x) {
    if (dtab[k] != 0.0f) atomicAdd(&d_table[k], dtab[k]);
  }
  if (threadIdx.x < 12) atomicAdd(&d_cam_g[threadIdx.x], dcam_s[threadIdx.x]);
}

}  // namespace

extern "C" int trt_regen_bwd(float* dstate, int r, const float* cam13,
                             const float* table, int n, const int16_t* rec,
                             const float* chk, const int* t_end, int steps,
                             int seg, int use_sky, int max_bounces, int width,
                             int height, float film_w, float film_h,
                             float* d_table, float* d_cam,
                             cudaStream_t stream) {
  const size_t smem = ((size_t)24 * n + 12) * sizeof(float);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (seg < 1 || seg > TRT_SEG_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h};
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  regen_bwd_kernel<<<blocks, threads, smem, stream>>>(
      dstate, r, cam13, table, n, rec, chk, t_end, steps, seg, p, d_table,
      d_cam);
  return (int)cudaGetLastError();
}
