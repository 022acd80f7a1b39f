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
// [n_tiles, 6] (bounce_step.tri_tile_boxes); the Morton sphere tiles of
// the table's sphere rows (regen.sphere_tiles). lidx [L] i32: the lights'
// ids in the permuted table; ldat [L, 6]: their centres and emissives.
// n_lights < 0 runs flat. out [4, r]: colour sum over the samples, rays.
//
// Bound on the H100: fp32 ALU. Each sample of a lane tests the spheres of
// the Morton sphere tiles its ray enters (~20 flops a pair, ~20 a tile or
// group box) and the triangles of the tiles it needs from its block's
// list (14, 24 or 46 flops a pair by where it leaves trt_tri_hit), and
// each Lambert hit does the same for one shadow ray a light; a lane moves
// 12 B in and 16 B out for all its samples. With -fmad=false no multiply
// and add fuse, so the kernel reaches at most half of a bound priced at
// the 67 TFLOP/s fp32 peak.
// Design: one thread per lane, 256-lane blocks, the lane's samples in
// registers from the first to the last (the TPU kernel's spp unroll);
// nothing but the output leaves the chip. Against the bound, each fold
// tests as few pairs as it can while its winner stays the plain
// version's:
// - The spheres (centre, radius) sit in shared memory with their Morton
//   tiles' boxes, group boxes and starts (kernels/regen.py sphere_tiles,
//   K2's and K4's search: common.cuh trt_fold_sph_tiles). A lane folds a
//   tile only where its ray enters the tile's inflated box at no more than
//   its best so far, in ascending order with strict <, so the winner is
//   the fold over every slot's bit for bit; padding's tiles have empty
//   boxes, which no ray enters (sixteen: 16 spheres in 128 slots).
// - The triangles of a fold come from a list its block builds in the
//   launch: the tiles whose inflated boxes its active lanes' rays reach,
//   ordered by the least entry distance (common.cuh
//   trt_block_list_ordered: tri_block_lists at block_r = 256, group 1,
//   front to back). The block folds them front to back
//   (trt_fold_tiles_ordered, K8's fold): it stages a tile only when a
//   lane's ray enters its box before that lane's best hit, a tile that
//   few lanes of a warp need is tested by the warp for each of them in
//   turn, the walk stops once no lane's best reaches the next tile, and
//   the winner is compared by (t, id), so an exact tie keeps the lowest
//   id as the ascending fold does.
// - A primary fold lists from the block's primary rays; a shadow fold,
//   for each light, from its hit lanes' shadow rays (the in-launch form of
//   the TPU kernel's origin-box shadow lists, tighter than them), after
//   the spheres, so the light's own t bounds the triangle walk. A block
//   with no hit lane skips a shadow fold. Either list can pass over only a
//   grazing hit that Möller-Trumbore accepts outside its tile's inflated
//   box, the fuzz every list of the port allows against a full sweep.
// - The last tile's trailing padding rows (e1 = e2 = 0, whose det is 0,
//   so they never hit) are left out of every fold: 46 of trilight's 128
//   triangle rows, which nearly every one of its searches tests.
// - Without boxes (the mode a caller names), every fold sweeps every tile
//   in id order, staged through shared memory.
// The block's threads run together: every barrier and vote is reached by
// all of them, a lane past r staying inactive. The TPU kernel's K-stacked
// bf16 search, packed argmin, one-hot winner gather and host-side frustum
// lists grouped for SMEM are not carried over.
#include "regen_step.cuh"

#define TRT_SIMPLE_THREADS 256

namespace {

// K9's scene: table [n_sph + m, 12]; tri [m, 9] in tiles of block_m with
// boxes [n_tiles, 6] (nullptr: every fold sweeps every tile); sp: the
// sphere tiles; lidx [n_lights], ldat [n_lights, 6] (n_lights < 0: flat).
struct TrtSimpleScene {
  const float* table;
  int n_sph;
  const float* tri;
  int m, block_m;
  const float* boxes;
  int n_tiles;
  TrtSphTiles sp;
  const int* lidx;
  const float* ldat;
  int n_lights;
};

// The block's shared memory (dynamic, then the two static words).
struct TrtSimpleSmem {
  float4* sph;
  unsigned long long* ord;
  float *tile, *box, *gbox, *sbox, *sgbox;
  int *tst, *gst;
  int* cnt;
  unsigned* wmax;
};

// What a thread counts for stats (see trt_simple_trace): thread 0 the
// block's listed tiles and live folds, every lane its triangle pairs
// tested and its sphere boxes, tiles and pairs.
struct TrtSimpleCounts {
  unsigned listed[2], live[2];
  int tested;
  unsigned sph[3];
};

// The nearest hit of the lane's ray (o, d) over the spheres and then, on
// a triangle scene, the triangles [0, m_fold) (a primary fold, or a shadow
// fold with shadow set) -> its id, -1 on a miss or an inactive lane.
// Every thread of the block calls it (the triangle folds hold barriers).
__device__ int nearest(bool active, bool shadow, float ox, float oy,
                       float oz, float dx, float dy, float dz,
                       const TrtSimpleScene& sc, int m_fold,
                       const TrtSimpleSmem& sm, TrtSimpleCounts& c) {
  float best = TRT_F32_MAX;
  int bi = 0;
  // every lane of the warp runs the fold (its shuffles), the inactive ones
  // folding nothing; a warp with no active lane passes it by
  if (__any_sync(0xffffffffu, active)) {
    trt_fold_sph_tiles(sm.sph, sm.sbox, sm.tst, sm.sgbox, sm.gst,
                       sc.sp.n_groups, sc.sp.o_lim, active, ox, oy, oz, dx,
                       dy, dz, best, bi, c.sph);
  }
  if (sc.m > 0 && __syncthreads_or(active)) {    // uniform in the block
    c.live[shadow] += threadIdx.x == 0;
    if (sc.boxes) {
      const TrtRay ray = trt_ray(ox, oy, oz, dx, dy, dz);
      const int cnt = trt_block_list_ordered(active, ray, sm.box, sm.gbox,
                                             sc.n_tiles, sm.ord, sm.cnt);
      c.listed[shadow] += threadIdx.x == 0 ? (unsigned)cnt : 0u;
      trt_fold_tiles_ordered(sc.tri, m_fold, sc.block_m, sm.ord, cnt,
                             sm.box, sm.tile, sm.wmax, sc.n_sph, active, ray,
                             best, bi, c.tested);
    } else {
      trt_fold_tiles_staged(sc.tri, m_fold, sc.block_m, sc.n_tiles, sm.tile,
                            sc.n_sph, active, ox, oy, oz, dx, dy, dz, best,
                            bi);
      c.tested += active ? m_fold : 0;
    }
  }
  return active && best < TRT_F32_MAX ? bi : -1;
}

// Dynamic shared memory, in this order: n_sph spheres (float4); with
// boxes, the ordered list (trt_pow2_at_least(n_tiles) u64); a staged tile
// (9 * block_m floats); with boxes, the boxes (6 * n_tiles floats) and
// their group boxes (6 floats a group of 32 tiles); the sphere tiles'
// boxes and group boxes (6 floats each) and starts (n_tiles + 1 and
// n_groups + 1 ints). stats: nullptr, or 8 u64 added to (trt_simple_trace).
__global__ void __launch_bounds__(TRT_SIMPLE_THREADS, 3)
simple_trace_kernel(const float* __restrict__ rows, int r,
                    const float* __restrict__ cam13, TrtSimpleScene sc,
                    int spp, int s0, TrtRegenParams p,
                    unsigned long long* __restrict__ stats,
                    float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ int s_cnt, s_live;
  __shared__ unsigned s_wmax[32];
  if (threadIdx.x == 0) s_live = 0;
  const bool listed = sc.boxes != nullptr;
  const int n_ord = listed ? trt_pow2_at_least(sc.n_tiles) : 0;
  const int n_tgroups = listed ? (sc.n_tiles + 31) >> 5 : 0;
  TrtSimpleSmem sm;
  sm.sph = smem4;
  sm.ord = reinterpret_cast<unsigned long long*>(sm.sph + sc.n_sph);
  sm.tile = reinterpret_cast<float*>(sm.ord + n_ord);
  sm.box = sm.tile + 9 * sc.block_m;
  sm.gbox = sm.box + (listed ? 6 * sc.n_tiles : 0);
  sm.sbox = sm.gbox + 6 * n_tgroups;
  sm.sgbox = sm.sbox + 6 * sc.sp.n_tiles;
  sm.tst = reinterpret_cast<int*>(sm.sgbox + 6 * sc.sp.n_groups);
  sm.gst = sm.tst + sc.sp.n_tiles + 1;
  sm.cnt = &s_cnt;
  sm.wmax = s_wmax;
  for (int k = threadIdx.x; k < sc.n_sph; k += blockDim.x) {
    const float* w = sc.table + 12 * (size_t)k;
    sm.sph[k] = make_float4(w[0], w[1], w[2], w[3]);
  }
  if (listed) {
    for (int k = threadIdx.x; k < 6 * sc.n_tiles; k += blockDim.x) {
      sm.box[k] = sc.boxes[k];
    }
  }
  for (int k = threadIdx.x; k < 6 * sc.sp.n_tiles; k += blockDim.x) {
    sm.sbox[k] = sc.sp.boxes[k];
  }
  for (int k = threadIdx.x; k < 6 * sc.sp.n_groups; k += blockDim.x) {
    sm.sgbox[k] = sc.sp.gboxes[k];
  }
  for (int k = threadIdx.x; k <= sc.sp.n_tiles; k += blockDim.x) {
    sm.tst[k] = sc.sp.starts[k];
  }
  for (int k = threadIdx.x; k <= sc.sp.n_groups; k += blockDim.x) {
    sm.gst[k] = sc.sp.gstarts[k];
  }
  __syncthreads();
  // The last tile's trailing padding (e1 = e2 = 0: det = 0, never a hit)
  // is not folded: the folds end at its last other row.
  if (sc.m > 0) {
    const float* last = sc.tri + 9 * (size_t)(sc.m - sc.block_m);
    for (int q = threadIdx.x; q < sc.block_m; q += blockDim.x) {
      const float* w = last + 9 * q;
      if (w[3] != 0.0f || w[4] != 0.0f || w[5] != 0.0f || w[6] != 0.0f ||
          w[7] != 0.0f || w[8] != 0.0f) {
        atomicMax(&s_live, q + 1);
      }
    }
  }
  __syncthreads();
  const int m_fold = sc.m > 0 ? sc.m - sc.block_m + s_live : 0;
  if (listed) trt_group_boxes(sm.box, sc.n_tiles, sm.gbox);
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
  TrtSimpleCounts cn = {{0u, 0u}, {0u, 0u}, 0, {0u, 0u, 0u}};
  const TrtCam c = trt_load_cam(cam13);
  const bool flat = sc.n_lights < 0;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, rays = 0.0f;
  for (int s = s0; s < s0 + spp; ++s) {
    // ops/raygen.camera_rays of sample s
    const uint32_t base = trt_pcg_hash(h1 + (uint32_t)s * TRT_MIX_SAMPLE);
    float fx, fy, dx, dy, dz;
    trt_film_offsets(ax, ay, base, p, fx, fy);
    trt_film_vec(c, fx, fy, dx, dy, dz);
    trt_normalize_eps(dx, dy, dz);
    const float ox = c.px, oy = c.py, oz = c.pz;
    const int idx =
        nearest(in, false, ox, oy, oz, dx, dy, dz, sc, m_fold, sm, cn);
    const bool hit = idx >= 0;
    const float* w = sc.table + 12 * (size_t)(hit ? idx : 0);
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
      if (idx >= sc.n_sph) {
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
    for (int j = 0; j < sc.n_lights; ++j) {
      const float* ld = sc.ldat + 6 * j;
      float lx = ld[0] - nox, ly = ld[1] - noy, lz = ld[2] - noz;
      trt_normalize_eps(lx, ly, lz);
      const int sidx = nearest(hit, true, nox, noy, noz, lx, ly, lz, sc,
                               m_fold, sm, cn);
      if (hit) {
        const float lam = fmaxf(nx * lx + ny * ly + nz * lz, 0.0f);
        if (sidx == sc.lidx[j]) {
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
  if (stats) {
    const unsigned v[8] = {cn.listed[0], cn.listed[1], cn.live[0],
                           cn.live[1], (unsigned)cn.tested, cn.sph[0],
                           cn.sph[1], cn.sph[2]};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned x = __reduce_add_sync(0xffffffffu, v[q]);
      if ((threadIdx.x & 31) == 0 && x) {
        atomicAdd(stats + q, (unsigned long long)x);
      }
    }
  }
  if (!in) return;
  out[i] = acc0;
  out[(size_t)r + i] = acc1;
  out[(size_t)2 * r + i] = acc2;
  out[(size_t)3 * r + i] = rays;
}

}  // namespace

// rows [3, r]; cam13 [13]; table [n_sph + m, 12]; tri [m, 9] (nullptr
// when m = 0) in n_tiles tiles; boxes [n_tiles, 6] or nullptr (every tile
// on every fold); the sphere tiles sboxes [n_stiles, 6], sstarts
// [n_stiles + 1], sgboxes [n_sgroups, 6], sgstarts [n_sgroups + 1] for
// origins within o_lim; lidx [L] i32
// and ldat [L, 6] (n_lights = L; < 0 runs flat); stats nullptr or 8 u64
// added to: primary and shadow tiles listed (over the live block-folds),
// primary and shadow live block-folds (triangle folds a block ran),
// ray-triangle pairs tested (the triangles of each tile a lane tested,
// the last tile's trailing padding left out), sphere boxes tested (groups
// and tiles), sphere tiles folded, ray-sphere pairs tested; out [4, r].
extern "C" int trt_simple_trace(
    const float* rows, int r, const float* cam13, const float* table,
    int n_sph, const float* tri, int m, const float* boxes, int n_tiles,
    const float* sboxes, const int* sstarts, int n_stiles,
    const float* sgboxes, const int* sgstarts, int n_sgroups, float o_lim,
    const int* lidx, const float* ldat, int n_lights, int spp, int s0,
    int use_sky, int width, int height, float film_w, float film_h,
    unsigned long long* stats, float* out, cudaStream_t stream) {
  if (n_sph < 0 || m < 0 || spp < 0 || (m > 0 && tri == nullptr) ||
      (m > 0 && (n_tiles < 1 || m % n_tiles != 0)) ||
      (n_lights > 0 && (lidx == nullptr || ldat == nullptr)) ||
      sboxes == nullptr || sstarts == nullptr || sgboxes == nullptr ||
      sgstarts == nullptr || n_stiles < 1 || n_sgroups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) {
    n_tiles = 0;
    boxes = nullptr;
  }
  const int block_m = m > 0 ? m / n_tiles : 0;
  const bool listed = boxes != nullptr;
  const size_t smem =
      (size_t)n_sph * sizeof(float4) +
      (listed ? (size_t)trt_pow2_at_least(n_tiles) * 8 : 0) +
      ((size_t)9 * block_m +
       (listed ? 6 * (size_t)n_tiles + 6 * (size_t)((n_tiles + 31) >> 5)
               : 0) +
       6 * (size_t)(n_stiles + n_sgroups)) * sizeof(float) +
      (size_t)(n_stiles + n_sgroups + 2) * sizeof(int);
  if (smem > TRT_MAX_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = trt_set_smem(simple_trace_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (r == 0) return 0;
  // ids at or past n_sph are triangles
  const TrtRegenParams p{use_sky, 0, (float)width, (float)height, film_w,
                         film_h, n_sph};
  const TrtSimpleScene sc{table, n_sph, tri, m, block_m, boxes, n_tiles,
                          TrtSphTiles{sboxes, sstarts, n_stiles, sgboxes,
                                      sgstarts, n_sgroups, o_lim},
                          lidx, ldat, n_lights};
  const int blocks = (r + TRT_SIMPLE_THREADS - 1) / TRT_SIMPLE_THREADS;
  simple_trace_kernel<<<blocks, TRT_SIMPLE_THREADS, smem, stream>>>(
      rows, r, cam13, sc, spp, s0, p, stats, out);
  return (int)cudaGetLastError();
}
