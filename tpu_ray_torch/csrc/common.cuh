// Device functions shared by the search, regen and bounce kernels.
//
// Built with -fmad=false: every a*b+c below rounds twice, exactly as the
// plain PyTorch versions (tpu_ray_torch/ops) compute it one op at a time,
// so kernel and plain version agree bit for bit. Each expression keeps the
// plain version's association order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TRT_F32_EPS 1e-4f
#define TRT_F32_MAX 1e30f
// ops/intersect_tri.py _DET_EPS: |det| at or below it is no hit
#define TRT_DET_EPS 1e-9f

#define TRT_MIX_SAMPLE 0x85EBCA6Bu
#define TRT_MIX_BOUNCE 0x632BE59Bu
#define TRT_MIX_SLOT 0xC2B2AE35u

// The most dynamic shared memory a launch asks for.
#define TRT_MAX_SMEM_BYTES (200 * 1024)

// Stateless PCG permutation, bit-identical to core/rng.py pcg_hash.
__device__ __forceinline__ uint32_t trt_pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t shift = (state >> 28) + 4u;
  uint32_t word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

// core/rng.py draw_uniform: f32(u) * ((hi - lo) / 2^32) + lo, with the
// scale given exactly (a power of two for every range used).
__device__ __forceinline__ float trt_draw(uint32_t base, uint32_t bterm,
                                          uint32_t slot, float scale,
                                          float lo) {
  uint32_t u = trt_pcg_hash(base + bterm + slot * TRT_MIX_SLOT);
  return __uint2float_rn(u) * scale + lo;
}

// ops/vec.py safe_sqrt
__device__ __forceinline__ float trt_safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

// ops/vec.py normalize_eps: v * (1/sqrt(|v|^2)), 0 when |v|^2 <= eps.
__device__ __forceinline__ void trt_normalize_eps(float& x, float& y,
                                                  float& z) {
  float lsq = x * x + y * y + z * z;
  if (lsq > TRT_F32_EPS) {
    float inv = 1.0f / sqrtf(lsq);
    x = x * inv;
    y = y * inv;
    z = z * inv;
  } else {
    x = 0.0f;
    y = 0.0f;
    z = 0.0f;
  }
}

// ops/intersect.py nearest_hit folded over spheres [k0, k1) staged in
// shared memory as (cx, cy, cz, r) into a running (best, bi). Strict <
// keeps the lowest index on ties when ranges are folded in index order.
__device__ __forceinline__ void trt_fold_spheres(
    const float4* __restrict__ sph, int k0, int k1, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best, int& bi) {
  for (int i = k0; i < k1; ++i) {
    const float4 s = sph[i];
    const float mx = s.x - ox, my = s.y - oy, mz = s.z - oz;
    const float tp = mx * dx + my * dy + mz * dz;
    const float px = mx - dx * tp, py = my - dy * tp, pz = mz - dz * tp;
    const float dsq = px * px + py * py + pz * pz;
    const float r2 = s.w * s.w;
    if (dsq < r2) {
      const float x = trt_safe_sqrt(r2 - dsq);
      const float tn = tp - x;
      const float t = tn < TRT_F32_EPS ? tp + x : tn;
      if (t > TRT_F32_EPS && t < best) {
        best = t;
        bi = i;
      }
    }
  }
}

// ops/intersect.py nearest_hit for one ray over n spheres staged in shared
// memory. A miss leaves t = 1e30, idx = 0.
__device__ __forceinline__ void trt_nearest_sphere(
    const float4* __restrict__ sph, int n, float ox, float oy, float oz,
    float dx, float dy, float dz, float& t_out, int& idx_out) {
  t_out = TRT_F32_MAX;
  idx_out = 0;
  trt_fold_spheres(sph, 0, n, ox, oy, oz, dx, dy, dz, t_out, idx_out);
}

// ops/intersect_tri.py _mt_slab for one ray and the triangle (v0, e1,
// e2): Möller-Trumbore in the plain version's op order.
// -> whether it is a hit (|det| > 1e-9, u >= 0, v >= 0, u + v <= 1,
// t > 1e-4), with its t. A triangle that fails the det or u test returns
// early; every value it does compute is the plain version's.
__device__ __forceinline__ bool trt_tri_hit_regs(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, float ox, float oy, float oz, float dx,
    float dy, float dz, float& t) {
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > TRT_DET_EPS)) return false;
  const float inv = 1.0f / det;
  // tvec = o - v0
  const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  if (!(u >= 0.0f)) return false;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return v >= 0.0f && u + v <= 1.0f && t > TRT_F32_EPS;
}

// trt_tri_hit_regs of the triangle at w (v0, e1, e2: 9 floats).
__device__ __forceinline__ bool trt_tri_hit(const float* w, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& t) {
  return trt_tri_hit_regs(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7],
                          w[8], ox, oy, oz, dx, dy, dz, t);
}

// ops/intersect_tri.py nearest_hit_tri folded over the triangles [j0, j1)
// of a [*, 9] v0|e1|e2 table into a running (best, bi), triangle j taking
// the id id0 + j. Strict < keeps the lowest id on ties when ranges are
// folded in id order (after the spheres, the rule of merge_payloads).
__device__ __forceinline__ void trt_fold_tris(
    const float* __restrict__ tri, int j0, int j1, int id0, float ox,
    float oy, float oz, float dx, float dy, float dz, float& best,
    int& bi) {
  for (int j = j0; j < j1; ++j) {
    float t;
    if (trt_tri_hit(tri + 9 * (size_t)j, ox, oy, oz, dx, dy, dz, t) &&
        t < best) {
      best = t;
      bi = id0 + j;
    }
  }
}

// trt_fold_tris with the winner by (t, id) in that order: a triangle
// takes the lead with a smaller t, or the same t and a lower id. Folds
// that visit the tiles out of id order (trt_fold_tiles_ordered) keep the
// lowest id on an exact tie with it, as an ascending fold with strict <
// does.
__device__ __forceinline__ void trt_fold_tris_lex(
    const float* __restrict__ tri, int j0, int j1, int id0, float ox,
    float oy, float oz, float dx, float dy, float dz, float& best,
    int& bi) {
  for (int j = j0; j < j1; ++j) {
    float t;
    if (trt_tri_hit(tri + 9 * (size_t)j, ox, oy, oz, dx, dy, dz, t) &&
        (t < best || (t == best && id0 + j < bi))) {
      best = t;
      bi = id0 + j;
    }
  }
}

// A ray for the slab tests of the tile lists: origin, direction and the
// reciprocal of each nonzero direction component, taken once for all the
// boxes (the plain version's 1 / d, a true division, so the same f32).
struct TrtRay {
  float o[3], d[3], inv[3];
};

__device__ __forceinline__ TrtRay trt_ray(float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  TrtRay r;
  r.o[0] = ox; r.o[1] = oy; r.o[2] = oz;
  r.d[0] = dx; r.d[1] = dy; r.d[2] = dz;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.inv[k] = r.d[k] != 0.0f ? 1.0f / r.d[k] : 0.0f;
  return r;
}

// kernels/bounce_step.py _block_reach for one ray and one tile box
// (lo.xyz, hi.xyz): does the ray meet the box at some t >= 0? -> and tl,
// where it does: the slab test's lower end (>= 0), the distance at which
// the ray enters the box. The plain version's values: its torch.maximum /
// torch.minimum carry a NaN (0 * inf where a box face meets the origin of
// a ray with an overflowing reciprocal) to a miss, here a flag; an axis
// the ray runs parallel to admits the ray if its origin lies between the
// faces and rules it out otherwise, as the plain version's +-3e38 do.
// MAYBE: -> false only where the ray surely misses the box (a NaN
// answers true), the prefilter of trt_group_boxes.
template <bool MAYBE = false>
__device__ __forceinline__ bool trt_slab_entry(const TrtRay& r,
                                               const float* box,
                                               float& tl_out) {
  float tl = 0.0f, th = 3.0e38f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k], hi = box[3 + k];
    if (r.d[k] == 0.0f) {
      if (!(r.o[k] >= lo && r.o[k] <= hi)) return false;
    } else {
      const float a0 = (lo - r.o[k]) * r.inv[k];
      const float a1 = (hi - r.o[k]) * r.inv[k];
      nan |= (a0 != a0) | (a1 != a1);
      tl = fmaxf(tl, fminf(a0, a1));
      th = fminf(th, fmaxf(a0, a1));
    }
  }
  tl_out = tl;
  if (MAYBE && nan) return true;
  return !nan && th >= tl && th >= 0.0f;
}

// The boxes of groups of 32 consecutive tiles, for a prefilter of the
// list build: gbox [ceil(n_tiles / 32), 6] (shared) gets each group's
// union of the tile boxes box [n_tiles, 6], or the whole space where a
// tile of the group is empty (lo > hi: the slab test's answer for it is
// not monotone). A group box holds each of its tiles' boxes, so for
// every f32 ray its slab interval holds theirs (each rounded step is
// monotone): a ray that surely misses it (trt_slab_entry<true> false)
// misses all 32 tiles, and the list is the one tile-by-tile tests give.
// Every thread of the block calls it (it ends in a barrier).
__device__ __forceinline__ void trt_group_boxes(const float* box,
                                                int n_tiles, float* gbox) {
  const int n_groups = (n_tiles + 31) >> 5;
  const float inf = __int_as_float(0x7f800000);
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    float lo[3] = {inf, inf, inf};
    float hi[3] = {-inf, -inf, -inf};
    bool whole = false;
    for (int t = 32 * g; t < min(32 * g + 32, n_tiles); ++t) {
      const float* b = box + 6 * t;
      whole |= !(b[0] <= b[3] && b[1] <= b[4] && b[2] <= b[5]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], b[k]);
        hi[k] = fmaxf(hi[k], b[3 + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gbox[6 * g + k] = whole ? -inf : lo[k];
      gbox[6 * g + 3 + k] = whole ? inf : hi[k];
    }
  }
  __syncthreads();
}

// The entries of trt_block_list_ordered's list: a power of two >= n.
__host__ __device__ __forceinline__ int trt_pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The block's list of reachable triangle tiles (kernels/bounce_step.py
// tri_block_lists at block_r = blockDim.x, group 1: tile t is listed if
// the ray of an active lane meets its box, box [n_tiles, 6] in shared
// memory), ordered front to back: ord[k] = (key << 32) | tile, ascending,
// where a listed tile's key is the f32 bits of the least entry distance
// (trt_slab_entry's tl) over the active lanes that reach it, and a tie of
// keys goes to the lower tile id. Each warp takes the
// min of its reaching lanes' entries (__reduce_min_sync on the bits, in
// the order of the non-negative floats) and its first lane folds it into
// the tile's entry with a 64-bit shared atomicMin; a bitonic sort of the
// trt_pow2_at_least(n_tiles) entries then puts the listed tiles first
// (an unreached tile keeps key 0xffffffff). -> the count. Every thread
// of the block calls it (it holds barriers). gbox: trt_group_boxes of
// box; ord: that many u64 of shared memory; cnt: one shared int.
__device__ __forceinline__ int trt_block_list_ordered(
    bool active, const TrtRay& ray, const float* box, const float* gbox,
    int n_tiles, unsigned long long* ord, int* cnt) {
  const int n_ord = trt_pow2_at_least(n_tiles);
  const int n_groups = (n_tiles + 31) >> 5;
  const unsigned long long unreached = 0xffffffffull << 32;
  for (int t = threadIdx.x; t < n_ord; t += blockDim.x) {
    ord[t] = unreached | (unsigned)t;
  }
  if (threadIdx.x == 0) *cnt = 0;
  __syncthreads();
  // a warp tests the tiles of a group (gbox, trt_group_boxes) only where
  // one of its lanes may meet the group's box
  for (int g = 0; g < n_groups; ++g) {
    float tg;
    const bool in_g = active && trt_slab_entry<true>(ray, gbox + 6 * g, tg);
    if (!__any_sync(0xffffffffu, in_g)) continue;   // uniform in the warp
    for (int t = 32 * g; t < min(32 * g + 32, n_tiles); ++t) {
      float tl = 0.0f;
      const bool f = in_g && trt_slab_entry(ray, box + 6 * t, tl);
      if (__any_sync(0xffffffffu, f)) {
        // tl >= 0: clear the sign of a -0 so the bits order as the floats
        const unsigned near = __reduce_min_sync(
            0xffffffffu, f ? (__float_as_uint(tl) & 0x7fffffffu)
                           : 0xffffffffu);
        if ((threadIdx.x & 31) == 0) {
          atomicMin(ord + t,
                    ((unsigned long long)near << 32) | (unsigned)t);
        }
      }
    }
  }
  __syncthreads();
  for (int size = 2; size <= n_ord; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < n_ord / 2; q += blockDim.x) {
        const int lo = 2 * stride * (q / stride) + q % stride;
        const int hi = lo + stride;
        const unsigned long long a = ord[lo], b = ord[hi];
        if ((a > b) == ((lo & size) == 0)) {
          ord[lo] = b;
          ord[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int q = threadIdx.x; q < n_ord; q += blockDim.x) {
    if (ord[q] < unreached && (q + 1 == n_ord || ord[q + 1] >= unreached)) {
      *cnt = q + 1;
    }
  }
  __syncthreads();
  return *cnt;
}

// trt_fold_tris over the tiles 0..cnt-1 in order of a [m, 9] v0|e1|e2
// table, tile t holding triangles [t * block_m, min((t + 1) * block_m, m))
// with ids id0 + j.
// Each tile is staged into shared memory (block_m * 9 floats at tile) by
// the whole block and every thread reads the same triangle at once, a
// broadcast. Every thread of the block calls it (it holds barriers);
// only active lanes fold.
__device__ __forceinline__ void trt_fold_tiles_staged(
    const float* __restrict__ tri, int m, int block_m, int cnt,
    float* tile, int id0, bool active, float ox, float oy, float oz,
    float dx, float dy, float dz, float& best, int& bi) {
  for (int k = 0; k < cnt; ++k) {
    const int j0 = k * block_m;
    const int nj = min(block_m, m - j0);
    __syncthreads();     // every thread is done with the previous tile
    for (int q = threadIdx.x; q < 9 * nj; q += blockDim.x) {
      tile[q] = tri[(size_t)9 * j0 + q];
    }
    __syncthreads();
    if (active) {
      trt_fold_tris(tile, 0, nj, id0 + j0, ox, oy, oz, dx, dy, dz, best, bi);
    }
  }
}

// A warp's lanes that need more than this many of a tile's triangles
// fold them each on their own; fewer share the warp (trt_fold_tile_warp).
#define TRT_WARP_SHARE_LANES 16

// trt_fold_tris_lex over the nj staged triangles of one tile (ids id0 +
// j) for the lanes of a warp that need it. Where many lanes need the
// tile, each folds it on its own. Where few do, the warp takes them in
// turn: each thread tests every 32nd triangle against the lane's ray
// (shuffled to all), a butterfly of shuffles takes the least (t, id) of
// their hits, and the lane folds that one into its best, so a tile that
// one lane of a warp needs costs the warp nj / 32 tests, not nj. The
// least (t, id) is the same whatever the order of the comparisons, so
// both give the winner of the one-by-one fold. Every lane of the warp
// calls it.
__device__ __forceinline__ void trt_fold_tile_warp(const float* tile,
                                                   int nj, int id0,
                                                   bool need,
                                                   const TrtRay& ray,
                                                   float& best, int& bi) {
  unsigned mask = __ballot_sync(0xffffffffu, need);
  if (__popc(mask) > TRT_WARP_SHARE_LANES) {
    if (need) {
      trt_fold_tris_lex(tile, 0, nj, id0, ray.o[0], ray.o[1], ray.o[2],
                        ray.d[0], ray.d[1], ray.d[2], best, bi);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ox = __shfl_sync(0xffffffffu, ray.o[0], src);
    const float oy = __shfl_sync(0xffffffffu, ray.o[1], src);
    const float oz = __shfl_sync(0xffffffffu, ray.o[2], src);
    const float dx = __shfl_sync(0xffffffffu, ray.d[0], src);
    const float dy = __shfl_sync(0xffffffffu, ray.d[1], src);
    const float dz = __shfl_sync(0xffffffffu, ray.d[2], src);
    float bt = __int_as_float(0x7f800000);
    int bj = nj;                                   // nj: no hit
    for (int j = lane; j < nj; j += 32) {
      float t;
      if (trt_tri_hit(tile + 9 * j, ox, oy, oz, dx, dy, dz, t) &&
          (t < bt || (t == bt && j < bj))) {
        bt = t;
        bj = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    if (lane == src && bj < nj &&
        (bt < best || (bt == best && id0 + bj < bi))) {
      best = bt;
      bi = id0 + bj;
    }
  }
}

// The fold of trt_fold_tiles_staged over trt_block_list_ordered's tiles
// ord[0..cnt), front to back, with an early exit. A lane needs a tile
// only where its ray enters the tile's box (box [n_tiles, 6], shared) at
// no more than its best t; the block stages a tile only when some lane
// needs it (a warp whose lanes all pass it by does no work), and as the
// tiles come in the order of the block's least entry, it stops once no
// active lane's best reaches the next tile's key. The winner is compared
// by (t, id) (trt_fold_tris_lex), so it is the ascending fold's over the
// listed tiles wherever a lane's winner lies inside its tile's (inflated)
// box; a grazing hit that Möller-Trumbore accepts outside the box (the
// fuzz the lists already allow against a full sweep) can be passed over.
// A tile that few lanes of a warp need is shared by the warp
// (trt_fold_tile_warp). wmax: one shared u32 a warp (the f32 bits of its
// lanes' largest best, refreshed after each fold). tested: += the
// triangles of the tiles this lane tested (ray-triangle pairs).
// Every thread of the block calls it (it holds barriers); only active
// lanes fold.
__device__ __forceinline__ void trt_fold_tiles_ordered(
    const float* __restrict__ tri, int m, int block_m,
    const unsigned long long* ord, int cnt, const float* box, float* tile,
    unsigned* wmax, int id0, bool active, const TrtRay& ray, float& best,
    int& bi, int& tested) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  // best >= 0 where it is set: its bits order as the floats
  const unsigned mine = __reduce_max_sync(
      0xffffffffu, active ? __float_as_uint(best) : 0u);
  if ((threadIdx.x & 31) == 0) wmax[warp] = mine;
  for (int k = 0; k < cnt; ++k) {
    const unsigned long long e = ord[k];
    const float near = __uint_as_float((unsigned)(e >> 32));
    const int t = (int)(unsigned)e;
    float tl;
    const bool need = active && near <= best &&
                      trt_slab_entry(ray, box + 6 * t, tl) && tl <= best;
    // a barrier too: every thread is done with the previous tile, and
    // every warp's wmax of the last fold is written
    if (!__syncthreads_or(need)) {
      unsigned top = 0u;
      for (int w = 0; w < n_warps; ++w) top = max(top, wmax[w]);
      if (near > __uint_as_float(top)) break;   // uniform in the block
      continue;
    }
    const int j0 = t * block_m;
    const int nj = min(block_m, m - j0);
    for (int q = threadIdx.x; q < 9 * nj; q += blockDim.x) {
      tile[q] = tri[(size_t)9 * j0 + q];
    }
    __syncthreads();
    trt_fold_tile_warp(tile, nj, id0 + j0, need, ray, best, bi);
    tested += need ? nj : 0;
    const unsigned w_best = __reduce_max_sync(
        0xffffffffu, active ? __float_as_uint(best) : 0u);
    if ((threadIdx.x & 31) == 0) wmax[warp] = w_best;
  }
}

// One pair of trt_fold_spheres: does the ray meet sphere s (cx, cy, cz, r)
// at some t > 1e-4? -> and t, the fold's own value (the same ops).
__device__ __forceinline__ bool trt_sphere_hit(const float4 s, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               float& t) {
  const float mx = s.x - ox, my = s.y - oy, mz = s.z - oz;
  const float tp = mx * dx + my * dy + mz * dz;
  const float px = mx - dx * tp, py = my - dy * tp, pz = mz - dz * tp;
  const float dsq = px * px + py * py + pz * pz;
  const float r2 = s.w * s.w;
  if (!(dsq < r2)) return false;
  const float x = trt_safe_sqrt(r2 - dsq);
  const float tn = tp - x;
  t = tn < TRT_F32_EPS ? tp + x : tn;
  return t > TRT_F32_EPS;
}

// The distance at which the ray enters a sphere tile's box (lo.xyz,
// hi.xyz): trt_slab_entry's tl where the ray meets the box, +inf where it
// surely misses or the box is empty (lo > hi: the slab test alone would
// take it for the box between its faces), and 0 where a NaN (0 * inf: a
// face through the origin of a ray with an overflowing reciprocal) leaves
// it unsure. An axis the ray runs parallel to rules the box out unless the
// origin lies between its faces. The plain version is kernels/regen.py
// _box_entry.
__device__ __forceinline__ float trt_box_entry(const TrtRay& r,
                                               const float* box) {
  if (!(box[0] <= box[3])) return __int_as_float(0x7f800000);
  float tl = 0.0f, th = 3.0e38f;
  bool nan = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = box[k], hi = box[3 + k];
    if (r.d[k] == 0.0f) {
      if (!(r.o[k] >= lo && r.o[k] <= hi)) return __int_as_float(0x7f800000);
    } else {
      const float a0 = (lo - r.o[k]) * r.inv[k];
      const float a1 = (hi - r.o[k]) * r.inv[k];
      nan |= (a0 != a0) | (a1 != a1);
      tl = fmaxf(tl, fminf(a0, a1));
      th = fminf(th, fmaxf(a0, a1));
    }
  }
  if (nan) return 0.0f;
  return th >= tl && th >= 0.0f ? tl : __int_as_float(0x7f800000);
}

// The most lanes of a warp that fold a sphere tile together
// (trt_fold_sph_tile_warp); tools/cull_variants.py times other limits.
#define TRT_SPH_SHARE_LANES 6

// trt_fold_spheres over the spheres [j0, j1) of one tile, staged in shared
// memory, for the lanes of a warp that need it. Where more than
// TRT_SPH_SHARE_LANES lanes need the tile, each folds it on its own.
// Where fewer do, the warp
// takes them two at a time: each half warp tests the tile's spheres (one
// a thread for tiles of up to 16) against one lane's ray
// (shuffled to it), four shuffle steps take the least (t, id) of the
// half's hits, and the lane folds that one into its best with strict <.
// The tiles come in ascending id order, so this is the one-by-one fold's
// winner: the least t, and the lowest id on an exact tie. Every lane of
// the warp calls it.
__device__ __forceinline__ void trt_fold_sph_tile_warp(
    const float4* sph, int j0, int j1, bool need, const TrtRay& ray,
    float& best, int& bi) {
  unsigned mask = __ballot_sync(0xffffffffu, need);
  if (!mask) return;
  if (__popc(mask) > TRT_SPH_SHARE_LANES) {
    if (need) {
      trt_fold_spheres(sph, j0, j1, ray.o[0], ray.o[1], ray.o[2], ray.d[0],
                       ray.d[1], ray.d[2], best, bi);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  while (mask) {
    const int s0 = __ffs(mask) - 1;
    mask &= mask - 1;
    const int s1 = mask ? __ffs(mask) - 1 : -1;
    if (mask) mask &= mask - 1;
    const int src = half && s1 >= 0 ? s1 : s0;
    const float ox = __shfl_sync(0xffffffffu, ray.o[0], src);
    const float oy = __shfl_sync(0xffffffffu, ray.o[1], src);
    const float oz = __shfl_sync(0xffffffffu, ray.o[2], src);
    const float dx = __shfl_sync(0xffffffffu, ray.d[0], src);
    const float dy = __shfl_sync(0xffffffffu, ray.d[1], src);
    const float dz = __shfl_sync(0xffffffffu, ray.d[2], src);
    float bt = __int_as_float(0x7f800000);
    int bj = j1;                                   // j1: no hit
    for (int j = j0 + (lane & 15); j < j1; j += 16) {
      float t;
      if (trt_sphere_hit(sph[j], ox, oy, oz, dx, dy, dz, t) &&
          (t < bt || (t == bt && j < bj))) {
        bt = t;
        bj = j;
      }
    }
    for (int off = 8; off > 0; off >>= 1) {        // within each half
      const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
      const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
      if (ot < bt || (ot == bt && oj < bj)) {
        bt = ot;
        bj = oj;
      }
    }
    const float t0 = __shfl_sync(0xffffffffu, bt, 0);
    const int i0 = __shfl_sync(0xffffffffu, bj, 0);
    const float t1 = __shfl_sync(0xffffffffu, bt, 16);
    const int i1 = __shfl_sync(0xffffffffu, bj, 16);
    if (lane == s0 && i0 < j1 && t0 < best) {
      best = t0;
      bi = i0;
    }
    if (lane == s1 && i1 < j1 && t1 < best) {
      best = t1;
      bi = i1;
    }
  }
}

// The culled sphere search of one step: trt_nearest_sphere's (best, bi)
// over the tiles of a sphere table in ascending order, tile t holding
// spheres [tst[t], tst[t + 1]) with the inflated box box[6 t .. 6 t + 6),
// and group g the tiles [gst[g], gst[g + 1]) with the union of their boxes
// gbox[6 g .. 6 g + 6) (all in shared memory). A lane tests a group's
// tiles only where its ray enters the group's box at no more than its best
// so far (a group of one tile is not tested apart), and folds a tile only
// where its ray enters the tile's box at no more than its best; a tile it
// skips cannot hold its nearest hit, whose point lies inside the box
// (kernels/regen.py sphere_tiles). A warp whose lanes all skip a group
// passes over it. A lane whose origin lies past o_lim (the origins the
// boxes were inflated for) folds every tile. counts += (boxes tested,
// tiles folded, pairs tested) of this lane. Every lane of the warp calls
// it; only active lanes fold. The plain version is kernels/regen.py
// nearest_sphere_culled.
__device__ __forceinline__ void trt_fold_sph_tiles(
    const float4* sph, const float* box, const int* tst, const float* gbox,
    const int* gst, int n_groups, float o_lim, bool active,
    float ox, float oy, float oz, float dx, float dy, float dz, float& best,
    int& bi, unsigned* counts) {
  best = TRT_F32_MAX;
  bi = 0;
  const TrtRay ray = trt_ray(ox, oy, oz, dx, dy, dz);
  const bool cull =
      active && fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz)) <= o_lim;
  for (int g = 0; g < n_groups; ++g) {
    const int t0 = gst[g], t1 = gst[g + 1];
    bool in_g = active;
    if (t1 - t0 > 1 && cull) {
      in_g = trt_box_entry(ray, gbox + 6 * g) <= best;
      counts[0] += 1u;
    }
    if (!__any_sync(0xffffffffu, in_g)) continue;   // uniform in the warp
    for (int t = t0; t < t1; ++t) {
      const int j0 = tst[t], j1 = tst[t + 1];
      bool need = in_g;
      if (in_g && cull) {
        need = trt_box_entry(ray, box + 6 * t) <= best;
        counts[0] += 1u;
      }
      if (need) {
        counts[1] += 1u;
        counts[2] += (unsigned)(j1 - j0);
      }
      trt_fold_sph_tile_warp(sph, j0, j1, need, ray, best, bi);
    }
  }
}

// The sphere tiles of a culled search (kernels/regen.py sphere_tiles;
// boxes nullptr: none), K4's and K9's: tile t holds spheres [starts[t],
// starts[t + 1]) with the inflated box boxes[6 t .. 6 t + 6), group g the
// tiles [gstarts[g], gstarts[g + 1]) with the union of their boxes.
struct TrtSphTiles {
  const float* boxes;
  const int* starts;
  int n_tiles;
  const float* gboxes;
  const int* gstarts;
  int n_groups;
  float o_lim;
};

// The sliced search of K1 (csrc/sphere_intersect.cu) and K7
// (csrc/tri_intersect.cu): where the ray blocks alone do not fill the
// card, the grid is ray blocks x slices of the primitive axis. Each block
// folds its slice in ascending id with strict <, then merges each hit into
// its ray's 64-bit key (f32 bits of t << 32 | id) with atomicMin: t > 0,
// so the bits order as the floats and an equal t keeps the lower id; the
// global min is the ascending fold's winner whatever order the blocks run
// in. The keys start all ones (trt_keys_clear; no hit makes that key, its
// t being a NaN), and trt_keys_unpack turns them into t and idx. At one
// slice the block writes t and idx itself.

// The devices whose resident blocks a kernel caches (trt_wave_of).
#define TRT_MAX_DEVICES 64

// The resident blocks of kernel (threads a block, no dynamic shared
// memory) a wave holds on the current device: its SMs x blocks an SM,
// queried once a device and kept in cache[TRT_MAX_DEVICES] (0: not yet).
// -> the count, or a negative CUDA error.
template <typename K>
__host__ inline int trt_wave_of(K kernel, int threads, int* cache) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  int wave = dev < TRT_MAX_DEVICES ? cache[dev] : 0;
  if (wave == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, 0);
    }
    if (err != cudaSuccess) return -(int)err;
    wave = n_sm * per_sm;
    if (dev < TRT_MAX_DEVICES) cache[dev] = wave;
  }
  return wave;
}

// The slices of a launch of r rays over m primitives, block_rays rays a
// block, wave resident blocks a wave -> at least 1; 1 where the ray
// blocks alone make `waves` waves, else enough slices for that many
// blocks, each slice at least min_slice primitives.
__host__ inline int trt_search_slices(long long r, long long m,
                                      int block_rays, int min_slice,
                                      int waves, int wave) {
  const long long want = (long long)waves * wave;
  const long long ray_blocks = (r + block_rays - 1) / block_rays;
  if (ray_blocks < 1 || ray_blocks >= want) return 1;
  const long long s = (want + ray_blocks - 1) / ray_blocks;
  const long long most = (m + min_slice - 1) / min_slice;
  return (int)(s < most ? s : most > 1 ? most : 1);
}

// Merge a slice's hit (t, id) into its ray's key.
__device__ __forceinline__ void trt_merge_hit(unsigned long long* key,
                                              float t, int id) {
  atomicMin(key, ((unsigned long long)__float_as_uint(t) << 32) |
                     (unsigned)id);
}

// Set the keys [r] of a split launch to all ones: no slice hit.
__host__ inline cudaError_t trt_keys_clear(unsigned long long* keys, int r,
                                           cudaStream_t stream) {
  return cudaMemsetAsync(keys, 0xff, (size_t)r * sizeof(unsigned long long),
                         stream);
}

namespace {

// keys [r] -> t_out, idx_out (all ones: a miss, t = 1e30, idx 0). K: the
// number of the search kernel, so that a profiler tells K1's from K7's.
template <int K>
__global__ void trt_unpack_keys_kernel(
    const unsigned long long* __restrict__ keys, int r,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r) return;
  const unsigned long long key = keys[i];
  const bool hit = key != ~0ull;
  t_out[i] = hit ? __uint_as_float((unsigned)(key >> 32)) : TRT_F32_MAX;
  idx_out[i] = hit ? (int)(unsigned)key : 0;
}

}  // namespace

// Launch trt_unpack_keys_kernel<K> over r keys.
template <int K>
__host__ inline cudaError_t trt_keys_unpack(
    const unsigned long long* keys, int r, float* t_out, int* idx_out,
    cudaStream_t stream) {
  trt_unpack_keys_kernel<K><<<(r + 255) / 256, 256, 0, stream>>>(
      keys, r, t_out, idx_out);
  return cudaGetLastError();
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename K>
__host__ inline cudaError_t trt_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
