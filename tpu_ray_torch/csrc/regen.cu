// K2: persistent-wavefront regen steps over the [24, R] state, in place,
// with an optional recording mode for the backward.
//
// Replaces tpu_ray/kernels/regen.py::regen_step: _regen_kernel (pallas_call
// at :868) and _regen_multi_kernel (steps > 1, pallas_call at :769),
// including their with_idx winner records, and, in triangle mode (a
// triangle search table is given), _regen_list_kernel (regen_step with
// tri_lists, pallas_call at :812). Each step is the K1 search over the
// shared-memory sphere table, then, in triangle mode, the Möller-Trumbore
// fold over every triangle in id order (common.cuh trt_fold_tris, strict
// <, so the winner is the lowest id in the one id space: spheres 0..N-1,
// triangles N..P-1), then trt_step_tail (regen_step.cuh): the _step_tail
// semantics of regen.py:167-224, shading a triangle in the plane form. The
// plain version is kernels/regen.py regen_steps_plain; this file repeats
// its f32 op sequence (see common.cuh on -fmad=false). Layout:
// kernels/regen.py.
//
// Bound on the H100: fp32 ALU. Each step of a lane searches every sphere
// (~20 flops a pair, 512 pairs for rtweekend) and every triangle (~45
// flops a Möller-Trumbore test that passes the det and u tests, 10,368
// triangles for trimesh) and then shades (~200 flops); the lane's 96 B of
// state is read and written once per launch, so device memory is idle
// next to the ALUs. Recording adds 2 B of winner record per lane-step and
// a 96 B checkpoint per lane every seg steps.
//
// Design: one thread owns one lane for the whole launch and keeps its state
// in registers across all `steps` steps, so the forward render is a single
// launch (steps = spp * max_bounces); the TPU kernel's per-step HBM round
// trip of the state disappears. The sphere table sits in shared memory
// (16 B a sphere) and every thread reads the same sphere at once, a
// broadcast. The triangle table (36 B a triangle, 373 KB for trimesh) does
// not fit shared memory: it is read from global memory through L1/L2,
// where it stays resident, and the lanes of a warp read the same triangle
// at once. The TPU kernel's reachable-tile lists (which only skip tiles
// that cannot hold the nearest hit) are not carried over: every lane
// sweeps every triangle; a per-lane tile cull is later speed work.
// Materials of the one winner per step come from the [P,12] table in
// global memory through L1/L2. A lane that is dead stays
// dead (alive is only set again by a live lane's regeneration), so it
// leaves the loop early and advances its bounce row by the steps it skips,
// as the plain version does; in recording mode it writes the count of
// steps it took (t_end) instead of the TPU kernel's dead-block sentinel,
// and leaves the records past it unwritten. Lanes of a warp that finish
// early idle until the warp's slowest lane is done; regeneration keeps
// that tail short (a lane runs spp samples).
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

template <bool RECORD>
int launch(float* state, int r, const float* cam13, const float* table,
           int n, const float* tri, int m, int steps, int use_sky,
           int max_bounces, int width, int height, float film_w,
           float film_h, int16_t* rec, float* chk, int* t_end, int seg,
           cudaStream_t stream) {
  if (m < 0 || m > n || (m > 0 && tri == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(n - m) * sizeof(float4);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  if (RECORD && seg <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(regen_steps_kernel<RECORD>, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0 || steps <= 0) return 0;
  const TrtRegenParams p{use_sky, max_bounces, (float)width, (float)height,
                         film_w, film_h, n - m};
  const int threads = 256;
  const int blocks = (r + threads - 1) / threads;
  regen_steps_kernel<RECORD><<<blocks, threads, smem, stream>>>(
      state, r, cam13, table, tri, m, steps, p, rec, chk, t_end, seg);
  return (int)cudaGetLastError();
}

}  // namespace

// state [24, r]; table [n, 12] (n - m sphere rows, then m triangle rows);
// tri [m, 9] v0|e1|e2 (nullptr when m = 0).
extern "C" int trt_regen_steps(float* state, int r, const float* cam13,
                               const float* table, int n, const float* tri,
                               int m, int steps, int use_sky,
                               int max_bounces, int width, int height,
                               float film_w, float film_h,
                               cudaStream_t stream) {
  return launch<false>(state, r, cam13, table, n, tri, m, steps, use_sky,
                       max_bounces, width, height, film_w, film_h, nullptr,
                       nullptr, nullptr, 1, stream);
}

// Recording mode: rec [steps, r] i16 (winner id on live lanes, -1 on a
// miss; entries at k >= t_end[i] unwritten), chk [ceil(steps/seg), 24, r]
// (the lane's state at every alive step k % seg == 0), t_end [r] i32.
extern "C" int trt_regen_steps_record(float* state, int r,
                                      const float* cam13, const float* table,
                                      int n, const float* tri, int m,
                                      int steps, int use_sky,
                                      int max_bounces, int width, int height,
                                      float film_w, float film_h,
                                      int16_t* rec, float* chk, int* t_end,
                                      int seg, cudaStream_t stream) {
  return launch<true>(state, r, cam13, table, n, tri, m, steps, use_sky,
                      max_bounces, width, height, film_w, film_h, rec, chk,
                      t_end, seg, stream);
}
