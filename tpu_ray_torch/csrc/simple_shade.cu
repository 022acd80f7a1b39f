// K9: the fused flat and Lambert+shadow estimators (kernels/simple_shade.py
// make_simple_trace): every spp sample of a lane in one launch.
//
// Replaces tpu_ray/kernels/simple_shade.py::make_simple_trace
// (_simple_kernel, pallas_call at :496), with exact_argmin. For each of
// its samples s0 .. s0 + spp - 1, in order, a lane regenerates its camera
// ray in place (regen_step.cuh, bit-equal to ops/raygen.camera_rays),
// searches the spheres and then the triangles (strict <, ids n_sph + j in
// the one id space), gathers the winner row of the [n, 12] table and
// shades: flat adds albedo + emissive of the hit, Lambert the emissive
// plus, for each light, albedo * light emissive * max(0, n . l) when the
// nearest hit of a shadow ray from the hit point toward the light centre
// is that light. The shading follows _simple_kernel's op order: the
// sphere normal from o + d t - c (far root when the near one is behind),
// a triangle winner in the plane form (t = (k - n.o) / (n.d), normal n,
// backface n.d > 0 flips it), the shadow ray from o + d t with no offset.
// A miss adds the sky (or zero). Rays: 1 a sample, plus 1 a light on a
// hit (occluded or not). Plain version: simple_trace_plain, whose f32 op
// sequence this file repeats (see common.cuh on -fmad=false).
//
// rows [3, r] f32: pixel x, pixel y, h1 (u32 bits: the per-(pixel, seed)
// hash; sample s's stream base is pcg_hash(h1 + s * MIX_SAMPLE)).
// cam13 [13] (kernels/regen.py cam13). table [n_sph + m, 12]
// (bounce_step.prim_table of the scene with its spheres Morton-permuted,
// its triangles in scene order). tri [m, 9] v0|e1|e2 and boxes
// [n_tiles, 6] (bounce_step.tri_tile_boxes). lidx [L] i32: the lights'
// ids in the permuted table; ldat [L, 6]: their centres and emissives.
// n_lights < 0 runs flat. out [4, r]: colour sum over the samples, rays.
//
// Bound on the H100: fp32 ALU. Each sample of a lane tests every real
// sphere (~20 flops a pair) and the triangles of the tiles its block
// lists (14, 24 or 46 flops a pair by where it leaves trt_tri_hit), and
// each Lambert hit does the same for one shadow ray a light; a lane moves
// 12 B in and 16 B out for all its samples.
// Design: one thread per lane, 256-lane blocks, the lane's samples in
// registers from the first to the last (the TPU kernel's spp unroll);
// nothing but the output leaves the chip. The sphere (centre, radius)
// table sits in shared memory, a broadcast. On a triangle scene the
// primary fold of each sample builds the block's tile list in the launch
// (common.cuh trt_block_list: the slab test of tri_block_lists, warp
// votes and ascending compaction) and folds the listed tiles staged
// through shared memory; shadow folds sweep every tile, staged the same
// way, and a block with no hit lane skips them. The TPU kernel's K-stacked bf16 search, packed
// argmin, one-hot winner gather, host-side frustum lists grouped for
// SMEM and origin-box shadow lists are not carried over.
#include "regen_step.cuh"

#define TRT_SIMPLE_THREADS 256

namespace {

// The nearest hit of the lane's ray (o, d) over the n_sph staged spheres
// and, with m > 0, the triangles of the block's listed tiles (listed) or
// of every tile -> its id, -1 on a miss or an inactive lane. Every thread
// of the block calls it (the triangle folds hold barriers).
__device__ int nearest(bool active, float ox, float oy, float oz, float dx,
                       float dy, float dz, const float4* sph, int n_sph,
                       const float* __restrict__ tri, int m, int block_m,
                       const float* box, int n_tiles, bool listed,
                       float* tile, int* scratch, int* lst) {
  float best = TRT_F32_MAX;
  int bi = 0;
  if (active) {
    trt_fold_spheres(sph, 0, n_sph, ox, oy, oz, dx, dy, dz, best, bi);
  }
  if (m > 0 && __syncthreads_or(active)) {
    int cnt = n_tiles;
    if (listed) {
      cnt = trt_block_list(active, ox, oy, oz, dx, dy, dz, box, n_tiles,
                           scratch, lst);
    }
    trt_fold_tiles_staged(tri, m, block_m, listed ? lst : nullptr, cnt,
                          tile, n_sph, active, ox, oy, oz, dx, dy, dz, best,
                          bi);
  }
  return active && best < TRT_F32_MAX ? bi : -1;
}

// Dynamic shared memory: n_sph spheres (float4), block_m * 9 floats of
// staged tile, n_tiles * 6 floats of boxes, trt_list_scratch(n_tiles)
// ints of list scratch and n_tiles ints of list. listed: build the
// primary folds' block lists (boxes given).
__global__ void simple_trace_kernel(
    const float* __restrict__ rows, int r, const float* __restrict__ cam13,
    const float* __restrict__ table, int n_sph,
    const float* __restrict__ tri, int m, const float* __restrict__ boxes,
    int n_tiles, int block_m, const int* __restrict__ lidx,
    const float* __restrict__ ldat, int n_lights, int spp, int s0,
    TrtRegenParams p, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* sph = smem4;
  float* tile = reinterpret_cast<float*>(sph + n_sph);
  float* box = tile + 9 * block_m;
  int* scratch = reinterpret_cast<int*>(box + 6 * n_tiles);
  int* lst = scratch + trt_list_scratch(n_tiles);
  for (int k = threadIdx.x; k < n_sph; k += blockDim.x) {
    const float* w = table + 12 * (size_t)k;
    sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  const bool listed = boxes != nullptr;
  if (listed) {
    for (int k = threadIdx.x; k < 6 * n_tiles; k += blockDim.x) {
      box[k] = boxes[k];
    }
  }
  __syncthreads();
  // no early return: every thread takes part in the block's barriers
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < r;
  float ax = 0.0f, ay = 0.0f;
  uint32_t h1 = 0u;
  if (in) {
    ax = rows[i];
    ay = rows[(size_t)r + i];
    h1 = __float_as_uint(rows[(size_t)2 * r + i]);
  }
  const TrtCam c = trt_load_cam(cam13);
  const bool flat = n_lights < 0;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, rays = 0.0f;
  for (int s = s0; s < s0 + spp; ++s) {
    // ops/raygen.camera_rays of sample s
    const uint32_t base = trt_pcg_hash(h1 + (uint32_t)s * TRT_MIX_SAMPLE);
    float fx, fy, dx, dy, dz;
    trt_film_offsets(ax, ay, base, p, fx, fy);
    trt_film_vec(c, fx, fy, dx, dy, dz);
    trt_normalize_eps(dx, dy, dz);
    const float ox = c.px, oy = c.py, oz = c.pz;
    const int idx = nearest(in, ox, oy, oz, dx, dy, dz, sph, n_sph, tri, m,
                            block_m, box, n_tiles, listed, tile, scratch,
                            lst);
    const bool hit = idx >= 0;
    const float* w = table + 12 * (size_t)(hit ? idx : 0);
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f, nox = 0.0f, noy = 0.0f,
          noz = 0.0f;
    if (hit && flat) {
      c0 = w[4] + w[7];
      c1 = w[5] + w[8];
      c2 = w[6] + w[9];
    } else if (hit) {
      // ops/intersect.hit_payload's roots from the winner row
      const float mx = w[0] - ox, my = w[1] - oy, mz = w[2] - oz;
      const float tp = mx * dx + my * dy + mz * dz;
      const float qx = mx - dx * tp, qy = my - dy * tp, qz = mz - dz * tp;
      const float dsq = qx * qx + qy * qy + qz * qz;
      const float x = trt_safe_sqrt(w[3] * w[3] - dsq);
      const float tn = tp - x;
      bool inside = tn < TRT_F32_EPS;
      float t = inside ? tp + x : tn;
      nx = (ox + dx * t) - w[0];
      ny = (oy + dy * t) - w[1];
      nz = (oz + dz * t) - w[2];
      trt_normalize_eps(nx, ny, nz);
      if (idx >= n_sph) {
        // a triangle row holds its plane (n, k) in the (centre, radius)
        // slots
        const float nd = dx * w[0] + dy * w[1] + dz * w[2];
        const float no = ox * w[0] + oy * w[1] + oz * w[2];
        t = (w[3] - no) / (nd == 0.0f ? 1.0f : nd);
        inside = nd > 0.0f;
        nx = w[0];
        ny = w[1];
        nz = w[2];
        trt_normalize_eps(nx, ny, nz);
      }
      nox = ox + dx * t;
      noy = oy + dy * t;
      noz = oz + dz * t;
      if (inside) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
      }
      c0 = w[7];
      c1 = w[8];
      c2 = w[9];
    }
    rays = rays + 1.0f;
    // the light loop's trip count is the same for every thread, so each
    // shadow fold's barriers are reached by all of them
    for (int j = 0; j < n_lights; ++j) {
      const float* ld = ldat + 6 * j;
      float lx = ld[0] - nox, ly = ld[1] - noy, lz = ld[2] - noz;
      trt_normalize_eps(lx, ly, lz);
      const int sidx = nearest(hit, nox, noy, noz, lx, ly, lz, sph, n_sph,
                               tri, m, block_m, box, n_tiles, false, tile,
                               scratch, lst);
      if (hit) {
        const float lam = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
        if (sidx == lidx[j]) {
          c0 = c0 + (w[4] * ld[3]) * lam;
          c1 = c1 + (w[5] * ld[4]) * lam;
          c2 = c2 + (w[6] * ld[5]) * lam;
        }
        rays = rays + 1.0f;
      }
    }
    if (!hit && p.use_sky) {
      // ops/shade.sky_color
      const float a = (dy + 1.0f) * 0.5f;
      const float oma = 1.0f - a;
      c0 = oma * 1.0f + a * 0.5f;
      c1 = oma * 1.0f + a * 0.7f;
      c2 = oma * 1.0f + a * 1.0f;
    }
    acc0 = acc0 + c0;
    acc1 = acc1 + c1;
    acc2 = acc2 + c2;
  }
  if (!in) return;
  out[i] = acc0;
  out[(size_t)r + i] = acc1;
  out[(size_t)2 * r + i] = acc2;
  out[(size_t)3 * r + i] = rays;
}

}  // namespace

// rows [3, r]; cam13 [13]; table [n_sph + m, 12]; tri [m, 9] (nullptr
// when m = 0); boxes [n_tiles, 6] or nullptr (every tile on every fold);
// lidx [L] i32 and ldat [L, 6] (n_lights = L; < 0 runs flat); out [4, r].
extern "C" int trt_simple_trace(const float* rows, int r, const float* cam13,
                                const float* table, int n_sph,
                                const float* tri, int m, const float* boxes,
                                int n_tiles, const int* lidx,
                                const float* ldat, int n_lights, int spp,
                                int s0, int use_sky, int width, int height,
                                float film_w, float film_h, float* out,
                                cudaStream_t stream) {
  if (n_sph < 0 || m < 0 || spp < 0 || (m > 0 && tri == nullptr) ||
      (m > 0 && (n_tiles < 1 || m % n_tiles != 0)) ||
      (n_lights > 0 && (lidx == nullptr || ldat == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) {
    n_tiles = 0;
    boxes = nullptr;
  }
  const int block_m = m > 0 ? m / n_tiles : 0;
  const size_t smem = (size_t)n_sph * sizeof(float4) +
                      ((size_t)9 * block_m + 6 * n_tiles) * sizeof(float) +
                      (size_t)(trt_list_scratch(n_tiles) + n_tiles) *
                          sizeof(int);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(simple_trace_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  // ids at or past n_sph are triangles
  const TrtRegenParams p{use_sky, 0, (float)width, (float)height, film_w,
                         film_h, n_sph};
  const int blocks = (r + TRT_SIMPLE_THREADS - 1) / TRT_SIMPLE_THREADS;
  simple_trace_kernel<<<blocks, TRT_SIMPLE_THREADS, smem, stream>>>(
      rows, r, cam13, table, n_sph, tri, m, boxes, n_tiles, block_m, lidx,
      ldat, n_lights, spp, s0, p, out);
  return (int)cudaGetLastError();
}
