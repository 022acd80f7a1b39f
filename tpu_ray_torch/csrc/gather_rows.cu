// K11: the table gradient of a row gather, d_table[k] = sum of g[r] over
// every lane r with idx[r] == k, in one fixed order.
//
// Replaces no pallas_call: it is the backward of the custom VJP
// tpu_ray/ops/intersect.py gather_rows (_gather_rows_bwd, :81-89), which
// hit_payload and tri_payload call on the sphere [n,12] and triangle
// [m,17] payload tables. Contract: d_table [n, w] f32, rows no lane
// gathers +0.0, idx int32 in [0, n) (not checked here: the forward's
// index_select of the same idx has checked it), idx gets no gradient.
//
// The TPU's one_hot(idx)^T @ g on the MXU is TPU mechanism (an [R, n]
// product: 3.4e11 entries at bigmesh's) and is not carried over. PyTorch's
// backward of table[idx] sums each run of equal indices serially in one
// warp, and one run can be the whole wavefront (every miss gathers row 0):
// on bigmesh that took 4.8 s of a 5 s step. So no run is summed by one
// thread past TRT_GR_CHUNK entries, and no float atomics are used: d_table
// is the same from run to run.
//
// The stable order (mirrored by kernels/gather_rows.py stable_order_plain):
// an LSD counting sort of (key, lane id), both int32, over only the bits
// that n - 1 needs, split evenly over the fewest passes of at most
// TRT_GR_RADIX bits (n = 128: one pass of 7 bits; n = 163,968: two of 9;
// n = 1: none, the lanes are already in order). A pass cuts its input into
// tiles of TRT_GR_TILE entries and runs three kernels: per-tile digit
// counts (gather_rows_hist_kernel), an exclusive scan of each digit's
// counts over the tiles, with the digit's total (gather_rows_scan_kernel),
// and the scatter (gather_rows_scatter_kernel). An entry's place is the
// digits before its own (their totals), its digit in the tiles before its
// tile, and its rank among its digit in its tile, taken in lane order:
// each warp owns a contiguous stretch of the tile and ranks its entries 32
// at a time (a lane's peers by one ballot a digit bit; __match_any_sync
// measured slower), and the warps' counts are scanned in warp order.
// Integer atomics only count (the histogram); no atomic picks a place. The
// scatter stages the tile in shared memory in digit order first, so a
// digit's entries leave as consecutive stores. The result is the unique
// stable order, torch.sort(idx, stable=True)'s bit for bit.
//
// The fold (mirrored by kernels/gather_rows.py fold_plain): level 0 is
// the sorted sequence of (key, g row); each level is cut into chunks of
// TRT_GR_CHUNK consecutive entries.
// - Down pass of a chunk: each run of equal keys inside it is folded in
//   order from +0.0; the fold at a run's last entry in the chunk is written
//   out (to d_table[key] on level 0, to the level's own row of that entry
//   above). The chunk's last entry's key and fold are its tail; the tails
//   of all chunks, in order, are the next level's sequence (still sorted).
//   A level of at most TRT_GR_CHUNK entries is the top.
// - Up pass (top level first): where chunk b's first run began in an
//   earlier chunk and ends in chunk b, its fold covers only chunk b. The
//   next level holds the run's sum over the earlier chunks (there the run
//   ends at entry b - 1): the run's sum is that + its fold. If the run ends
//   at chunk b's last entry, the next level's sum at entry b already holds
//   chunk b's part, and is taken as it is. The down pass records, a chunk,
//   which row the up pass must fix and from which entry (its fix word), so
//   the up pass reads no keys.
// So a run of L entries is summed by a tree of fan-in TRT_GR_CHUNK, whose
// shape depends on the sorted keys alone: 2^21 lanes on one row take five
// levels, each thread folding at most 32 entries.
//
// Launches of the fold. A block of gather_rows_down_kernel takes 32 x 32
// consecutive entries of a level (TRT_GR_GROUP): their keys and lane ids
// into shared memory once, then thread (chunk, column) folds one column of
// one chunk (the threads of a chunk read each of its g rows whole,
// consecutive threads on consecutive floats), with 16 row loads in flight
// a thread; then the block folds the 32 tails in shared memory as one
// chunk of the next level, in the same launch (the chunks of the next
// level line up with these groups, so the tree is the same). Its up pass
// (gather_rows_up_kernel) comes after the levels above are final; the one
// final sum of the next level it needs outside the group (entry 32g - 1)
// it rebuilds from that level's down fold and fix words. Once a level has
// at most TRT_GR_TOP_MAX entries, one block (gather_rows_top_kernel)
// folds it and every level above, down and up. At 2,073,600 lanes: down
// (levels 0-1), down (2-3), top (4), up (3, 2), up (1, 0): five launches
// after the memset of d_table, where the level-per-launch fold took nine.
//
// Bound on the H100: bytes. Each lane's idx and g row are read once and
// d_table written once; the order's int32 key and lane id move 3 x 16 B a
// lane a pass besides (read by the histogram, read and written by the
// scatter) and 8 B a lane in the fold. The fold's level 0 does all but a
// 1/32 of the work; its g rows are read in sorted order, a gather, which
// the bound does not price (PyTorch's own index_select of the same rows
// takes ~0.2 ms on the triangle table).
#include <cuda_runtime.h>

#define TRT_GR_CHUNK 32
#define TRT_GR_GROUP (TRT_GR_CHUNK * TRT_GR_CHUNK)
#define TRT_GR_COLS 32                  // columns a lane set folds at a time
#define TRT_GR_UP_WARPS 8               // each fixes 4 chunks of a group
#define TRT_GR_TOP_THREADS 1024
#define TRT_GR_TOP_MAX TRT_GR_GROUP
#define TRT_GR_HALF 16                  // row loads a thread keeps in flight
#define TRT_GR_MAX_LEVELS 8
#define TRT_GR_SORT_THREADS 256
#define TRT_GR_SORT_WARPS (TRT_GR_SORT_THREADS / 32)
#define TRT_GR_ITEMS 16                 // entries a thread ranks a pass
#define TRT_GR_TILE (TRT_GR_SORT_THREADS * TRT_GR_ITEMS)
#define TRT_GR_RADIX 9                  // bits a pass at most
#define TRT_GR_DIGITS (1 << TRT_GR_RADIX)
#define TRT_GR_DPT (TRT_GR_DIGITS / TRT_GR_SORT_THREADS)  // digits a thread
#define TRT_GR_MAX_PASSES 4
#define TRT_GR_FULL 0xffffffffu

namespace {

// Raise a kernel's dynamic shared memory limit to bytes where it is above
// the default 48 KB (once a device and size).
template <class K>
cudaError_t gr_allow_smem(K kernel, size_t bytes, int* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev < 0 || dev >= 64) return err;
  if (done[dev] >= (int)bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done[dev] = (int)bytes;
  return err;
}

// ---------------------------------------------------------------- sort

// Per-tile digit counts, digit-major: counts[d * ntiles + tile]. Each
// thread loads its TRT_GR_ITEMS keys first, then counts them.
__global__ void __launch_bounds__(TRT_GR_SORT_THREADS)
gather_rows_hist_kernel(const int* __restrict__ keys, int r, int shift,
                        int bits, int ntiles, int* __restrict__ counts) {
  __shared__ int h[TRT_GR_DIGITS];
  const int n_dig = 1 << bits;
  const int base = blockIdx.x * TRT_GR_TILE + threadIdx.x;
  int k[TRT_GR_ITEMS];
#pragma unroll
  for (int i = 0; i < TRT_GR_ITEMS; ++i) {
    const int j = base + i * TRT_GR_SORT_THREADS;
    k[i] = j < r ? keys[j] : -1;
  }
  for (int d = threadIdx.x; d < n_dig; d += TRT_GR_SORT_THREADS) h[d] = 0;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TRT_GR_ITEMS; ++i)
    if (k[i] >= 0) atomicAdd(&h[(k[i] >> shift) & (n_dig - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < n_dig; d += TRT_GR_SORT_THREADS)
    counts[(size_t)d * ntiles + blockIdx.x] = h[d];
}

// Block d: counts[d * ntiles + t] -> the count of digit d in tiles < t
// (in place), totals[d] -> the digit's count.
__global__ void __launch_bounds__(TRT_GR_SORT_THREADS)
gather_rows_scan_kernel(int* __restrict__ counts, int ntiles,
                        int* __restrict__ totals) {
  __shared__ int wsum[TRT_GR_SORT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = counts + (size_t)blockIdx.x * ntiles;
  int carry = 0;
  for (int base = 0; base < ntiles; base += TRT_GR_SORT_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(TRT_GR_FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < TRT_GR_SORT_WARPS ? wsum[lane] : 0;
      for (int o = 1; o < TRT_GR_SORT_WARPS; o <<= 1) {
        const int y = __shfl_up_sync(TRT_GR_FULL, s, o);
        if (lane >= o) s += y;
      }
      if (lane < TRT_GR_SORT_WARPS) wsum[lane] = s;
    }
    __syncthreads();
    if (i < ntiles) row[i] = carry + (warp ? wsum[warp - 1] : 0) + x - v;
    carry += wsum[TRT_GR_SORT_WARPS - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Exclusive scans of a[0, n) and b[0, n) in place, by the block: each
// warp scans its stretch of n / TRT_GR_SORT_WARPS entries, then adds the
// totals of the stretches before it (wa, wb: TRT_GR_SORT_WARPS ints of
// scratch each). Every thread of the block calls it.
__device__ void gr_block_scan2(int* a, int* b, int n, int* wa, int* wb,
                               int warp, int lane) {
  const int per = (n + TRT_GR_SORT_WARPS - 1) / TRT_GR_SORT_WARPS;
  const int lo = min(warp * per, n), hi = min(lo + per, n);
  int ca = 0, cb = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int va = i < hi ? a[i] : 0, vb = i < hi ? b[i] : 0;
    int xa = va, xb = vb;
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(TRT_GR_FULL, xa, o);
      const int yb = __shfl_up_sync(TRT_GR_FULL, xb, o);
      if (lane >= o) {
        xa += ya;
        xb += yb;
      }
    }
    if (i < hi) {
      a[i] = ca + xa - va;
      b[i] = cb + xb - vb;
    }
    ca += __shfl_sync(TRT_GR_FULL, xa, 31);
    cb += __shfl_sync(TRT_GR_FULL, xb, 31);
  }
  if (lane == 0) {
    wa[warp] = ca;
    wb[warp] = cb;
  }
  __syncthreads();
  int pa = 0, pb = 0;
  for (int u = 0; u < warp; ++u) {
    pa += wa[u];
    pb += wb[u];
  }
  for (int i = lo + lane; i < hi; i += 32) {
    a[i] += pa;
    b[i] += pb;
  }
}

// Dynamic shared memory of gather_rows_scatter_kernel over n_dig digits.
size_t gr_scatter_smem(int n_dig) {
  return ((size_t)(TRT_GR_SORT_WARPS + 2) * n_dig + 2 * TRT_GR_TILE) * 4;
}

// One pass of the sort over tile blockIdx.x: (keys_in, ids_in) -> their
// places in (keys_out, ids_out). kFirst: the input is idx itself, entry j
// of lane id j. Warp v owns entries [v, v + 1) x 32 x TRT_GR_ITEMS of the
// tile; its lanes hold items i x 32 + lane, ranked in item order, a
// lane's peers (the lanes of its digit) found by a ballot a digit bit.
template <bool kFirst>
__global__ void __launch_bounds__(TRT_GR_SORT_THREADS)
gather_rows_scatter_kernel(const int* __restrict__ keys_in,
                           const int* __restrict__ ids_in, int r, int shift,
                           int bits, int ntiles,
                           const int* __restrict__ counts,
                           const int* __restrict__ totals,
                           int* __restrict__ keys_out,
                           int* __restrict__ ids_out) {
  extern __shared__ int sm[];
  const int n_dig = 1 << bits, mask = n_dig - 1;
  int* hist = sm;                                  // [warps][n_dig]
  int* tbase = hist + TRT_GR_SORT_WARPS * n_dig;   // tile's first place
  int* gbase = tbase + n_dig;                      // global place of 0
  int* sk = gbase + n_dig;
  int* si = sk + TRT_GR_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * TRT_GR_TILE;
  const int seg = base + warp * 32 * TRT_GR_ITEMS;
  int k[TRT_GR_ITEMS], v[TRT_GR_ITEMS], rank[TRT_GR_ITEMS];
#pragma unroll
  for (int i = 0; i < TRT_GR_ITEMS; ++i) {
    const int j = seg + i * 32 + lane;
    k[i] = j < r ? keys_in[j] : 0;
    v[i] = kFirst ? j : (j < r ? ids_in[j] : 0);
  }
  int tot[TRT_GR_DPT], before[TRT_GR_DPT];
#pragma unroll
  for (int q = 0; q < TRT_GR_DPT; ++q) {
    const int d = threadIdx.x + q * TRT_GR_SORT_THREADS;
    tot[q] = d < n_dig ? totals[d] : 0;
    before[q] = d < n_dig ? counts[(size_t)d * ntiles + blockIdx.x] : 0;
  }
  int* wh = hist + warp * n_dig;
  for (int d = lane; d < n_dig; d += 32) wh[d] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < TRT_GR_ITEMS; ++i) {
    const bool valid = seg + i * 32 + lane < r;
    const int d = (k[i] >> shift) & mask;
    unsigned peers = __ballot_sync(TRT_GR_FULL, valid);
    for (int t = 0; t < bits; ++t) {
      const bool set = (d >> t) & 1;
      const unsigned on = __ballot_sync(TRT_GR_FULL, set);
      peers &= set ? on : ~on;
    }
    const int run = valid ? wh[d] : 0;
    rank[i] = run + __popc(peers & below);
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1) wh[d] = run + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // each warp's first place among the tile's entries of a digit; the
  // tile's count of each digit and the digits' totals, scanned below
#pragma unroll
  for (int q = 0; q < TRT_GR_DPT; ++q) {
    const int d = threadIdx.x + q * TRT_GR_SORT_THREADS;
    if (d < n_dig) {
      int s = 0;
      for (int u = 0; u < TRT_GR_SORT_WARPS; ++u) {
        const int t = hist[u * n_dig + d];
        hist[u * n_dig + d] = s;
        s += t;
      }
      tbase[d] = s;
      gbase[d] = tot[q];
    }
  }
  __syncthreads();
  gr_block_scan2(tbase, gbase, n_dig, sk, sk + TRT_GR_SORT_WARPS, warp,
                 lane);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < TRT_GR_DPT; ++q) {
    const int d = threadIdx.x + q * TRT_GR_SORT_THREADS;
    if (d < n_dig) gbase[d] += before[q] - tbase[d];
  }
#pragma unroll
  for (int i = 0; i < TRT_GR_ITEMS; ++i) {
    if (seg + i * 32 + lane < r) {
      const int d = (k[i] >> shift) & mask;
      const int at = tbase[d] + wh[d] + rank[i];
      sk[at] = k[i];
      si[at] = v[i];
    }
  }
  __syncthreads();
  const int cnt = min(TRT_GR_TILE, r - base);
  for (int j = threadIdx.x; j < cnt; j += TRT_GR_SORT_THREADS) {
    const int key = sk[j];
    const int at = gbase[(key >> shift) & mask] + j;
    keys_out[at] = key;
    ids_out[at] = si[j];
  }
}

// The order of a sort over no bits (n = 1): the lanes as they are.
__global__ void gather_rows_iota_kernel(const int* __restrict__ idx, int r,
                                        int* __restrict__ keys,
                                        int* __restrict__ ids) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < r) {
    keys[j] = idx[j];
    ids[j] = j;
  }
}

struct GrPlan {
  int passes, shift[TRT_GR_MAX_PASSES], bits[TRT_GR_MAX_PASSES];
  int ntiles, digits;
};

// The passes over the bits of keys in [0, n), split as evenly as
// possible over the fewest passes of at most TRT_GR_RADIX bits.
GrPlan gr_plan(int r, int n) {
  GrPlan p;
  int b = 0;
  while (b < 31 && (1 << b) < n) ++b;
  p.passes = (b + TRT_GR_RADIX - 1) / TRT_GR_RADIX;
  p.digits = 1;
  for (int i = 0, s = 0; i < p.passes; ++i) {
    p.bits[i] = b / p.passes + (i < b % p.passes);
    p.shift[i] = s;
    s += p.bits[i];
    if ((1 << p.bits[i]) > p.digits) p.digits = 1 << p.bits[i];
  }
  p.ntiles = (r + TRT_GR_TILE - 1) / TRT_GR_TILE;
  return p;
}

long long gr_round4(long long words) { return (words + 3) & ~3ll; }

// int32 words of the sort's scratch: two (key, id) buffers, the counts
// and the totals.
long long gr_sort_words(int r, int n) {
  const GrPlan p = gr_plan(r, n);
  return 4 * gr_round4(r) + gr_round4((long long)p.digits * p.ntiles)
         + TRT_GR_DIGITS;
}

int gr_scatter_done[2][64];

// The sorted order of idx into (keys, ids); (alt_keys, alt_ids), counts
// and totals are scratch. Needs plan.passes >= 1.
cudaError_t gr_sort(const int* idx, int r, const GrPlan& p, int* keys,
                    int* ids, int* alt_keys, int* alt_ids, int* counts,
                    int* totals, cudaStream_t stream) {
  const size_t smem = gr_scatter_smem(p.digits);
  cudaError_t err = gr_allow_smem(gather_rows_scatter_kernel<true>, smem,
                                  gr_scatter_done[0]);
  if (err == cudaSuccess)
    err = gr_allow_smem(gather_rows_scatter_kernel<false>, smem,
                        gr_scatter_done[1]);
  if (err != cudaSuccess) return err;
  const int* in_k = idx;
  const int* in_i = nullptr;
  for (int q = 0; q < p.passes; ++q) {
    const bool to_final = (p.passes - 1 - q) % 2 == 0;
    int* out_k = to_final ? keys : alt_keys;
    int* out_i = to_final ? ids : alt_ids;
    gather_rows_hist_kernel<<<p.ntiles, TRT_GR_SORT_THREADS, 0, stream>>>(
        in_k, r, p.shift[q], p.bits[q], p.ntiles, counts);
    gather_rows_scan_kernel<<<1 << p.bits[q], TRT_GR_SORT_THREADS, 0,
                              stream>>>(counts, p.ntiles, totals);
    const size_t sm = gr_scatter_smem(1 << p.bits[q]);
    if (q == 0)
      gather_rows_scatter_kernel<true><<<p.ntiles, TRT_GR_SORT_THREADS, sm,
                                         stream>>>(
          in_k, in_i, r, p.shift[q], p.bits[q], p.ntiles, counts, totals,
          out_k, out_i);
    else
      gather_rows_scatter_kernel<false><<<p.ntiles, TRT_GR_SORT_THREADS, sm,
                                          stream>>>(
          in_k, in_i, r, p.shift[q], p.bits[q], p.ntiles, counts, totals,
          out_k, out_i);
    in_k = out_k;
    in_i = out_i;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------- fold

// One level of the fold: its m sorted keys, the row of vals of each entry
// (ids[j], or j without ids), where its run ends' folds go (out: row key
// of d_table when by_key, else row j of the level's own [m, w]), each
// chunk's fix word for the up pass (gr_fix), and where its chunks' tails
// go (the next level's keys and vals; null at the top).
struct GrLevel {
  const int* keys;
  const int* ids;
  const float* vals;
  float* out;
  int* fix;
  int* tail_keys;
  float* tail_vals;
  int m, by_key;
};

struct GrLevels {
  GrLevel lv[TRT_GR_MAX_LEVELS];
};

// The up pass's fix word of a chunk of cnt entries (keys k[0, cnt); base:
// the first one's entry; before, after: the keys just before and after
// the chunk, -1 where there is none; keys are >= 0): -1 unless its first
// run began in an earlier chunk and ends in this one, at entry p; then
// row * 2 + (p is the chunk's last entry), row the run's row of the
// level's out (its key when by_key, else p). The up pass sets that row to
// the next level's final sum at entry b (p last) or to that at entry b - 1
// + the row's fold. One thread.
__device__ int gr_fix(const int* k, int cnt, int base, int before, int after,
                      int by_key) {
  const int k0 = k[0];
  if (before != k0) return -1;
  int p = 0;
  while (p + 1 < cnt && k[p + 1] == k0) ++p;
  if (p == cnt - 1 && after == k0) return -1;
  return (by_key ? k0 : base + p) * 2 + (p == cnt - 1);
}

// The down pass of one column of a chunk of cnt entries: keys k[0, cnt),
// its entries' rows ids[j] (base + j without ids) of vals, vw floats
// apart (vals points at the column). The TRT_GR_HALF loads of each part
// of the column are issued before its first add; each run is folded in
// order from +0.0, and each run end's fold written to out (ow floats a
// row, out pointing at the column; row key when by_key, else row first +
// j); after: the key after the chunk (-1 where there is none). The
// chunk's tail fold goes to *tail_val where given. One thread.
__device__ void gr_fold_col(const int* k, const int* ids, int cnt, int base,
                            const float* __restrict__ vals, int vw,
                            int after, float* out, int ow, int by_key,
                            int first, float* tail_val) {
  float acc = 0.0f;
  int prev = k[0];
#pragma unroll
  for (int h = 0; h < TRT_GR_CHUNK; h += TRT_GR_HALF) {
    float v[TRT_GR_HALF];
#pragma unroll
    for (int j = 0; j < TRT_GR_HALF; ++j)
      if (h + j < cnt)
        v[j] = vals[(size_t)(ids ? ids[h + j] : base + h + j) * vw];
#pragma unroll
    for (int j = 0; j < TRT_GR_HALF; ++j) {
      if (h + j < cnt) {
        const int kj = k[h + j];
        if (kj != prev) {
          out[(size_t)(by_key ? prev : first + h + j - 1) * ow] = acc;
          acc = 0.0f;
          prev = kj;
        }
        acc = acc + v[j];
      }
    }
  }
  if (after != prev) out[(size_t)(by_key ? prev : first + cnt - 1) * ow] = acc;
  if (tail_val) *tail_val = acc;
}

// The up pass of a row with fix word fx >= 0 of a level's out, one
// column: the next level's final sum u (at entry b when fx is odd, else
// at b - 1) replaces it (fx odd) or is added before it.
__device__ void gr_fix_col(float* out, int w, int fx, int col, float u) {
  float* o = out + (size_t)(fx >> 1) * w + col;
  *o = (fx & 1) ? u : u + *o;
}

// Levels l and l + 1, down (L.m > TRT_GR_TOP_MAX), block g: its 1024
// entries' keys and lane ids into shared memory; thread (q, c) folds
// column c0 + c of level l's chunk 32g + q (the wc threads of a chunk
// read each of its rows whole); then threads c < wc fold the 32 tails as
// level l + 1's chunk g (keys to L1.keys, run ends to L1.out), whose tail
// is level l + 2's entry g. Each chunk's fix word goes to its level's
// fix. Columns in tiles of TRT_GR_COLS (wc = min(w, TRT_GR_COLS) threads a
// chunk).
__global__ void __launch_bounds__(TRT_GR_CHUNK * TRT_GR_COLS)
gather_rows_down_kernel(GrLevel L, GrLevel L1, int w) {
  __shared__ int sk[TRT_GR_GROUP], si[TRT_GR_GROUP];
  __shared__ int tk[TRT_GR_CHUNK], edge[2];
  __shared__ float tv[TRT_GR_CHUNK * TRT_GR_COLS];
  const int t = threadIdx.x;
  const int wc = min(w, TRT_GR_COLS);
  const int g = blockIdx.x, b0 = g * TRT_GR_CHUNK;
  const int e0 = b0 * TRT_GR_CHUNK;
  const int m = min(TRT_GR_GROUP, L.m - e0);
  const int nc = min(TRT_GR_CHUNK, L1.m - b0);
  for (int j = t; j < m; j += blockDim.x) {
    sk[j] = L.keys[e0 + j];
    si[j] = L.ids ? L.ids[e0 + j] : e0 + j;
  }
  // the keys just before and after the group
  if (t == 0) edge[0] = g > 0 ? L.keys[e0 - 1] : -1;
  if (t == 1) edge[1] = e0 + m < L.m ? L.keys[e0 + m] : -1;
  __syncthreads();
  const int q = t / wc, c = t - q * wc;
  const int base = q * TRT_GR_CHUNK;
  const int cnt = q < nc ? min(TRT_GR_CHUNK, m - base) : 0;
  const int after = base + cnt < m ? sk[base + cnt] : edge[1];
  if (q < nc && c == 0) {
    L.fix[b0 + q] = gr_fix(sk + base, cnt, e0 + base,
                           q ? sk[base - 1] : edge[0], after, L.by_key);
    tk[q] = sk[base + cnt - 1];
  }
  // level l + 1's chunk g: its keys are the tails', the key before it the
  // tail of level l's chunk 32g - 1 (the key before the group), the one
  // after it that of chunk 32g + nc
  const int after1 = b0 + nc < L1.m
      ? L.keys[min((b0 + nc) * TRT_GR_CHUNK + TRT_GR_CHUNK - 1, L.m - 1)]
      : -1;
  for (int c0 = 0; c0 < w; c0 += TRT_GR_COLS) {
    const int wt = min(TRT_GR_COLS, w - c0);
    if (q < nc && c < wt)
      gr_fold_col(sk + base, si + base, cnt, 0, L.vals + c0 + c, w, after,
                  L.out + c0 + c, w, L.by_key, e0 + base,
                  tv + q * TRT_GR_COLS + c);
    __syncthreads();
    if (t < wt)
      gr_fold_col(tk, nullptr, nc, 0, tv + t, TRT_GR_COLS, after1,
                  L1.out + c0 + t, w, 0, b0,
                  L1.tail_vals + (size_t)g * w + c0 + t);
    if (c0 == 0) {
      for (int i = t; i < nc; i += blockDim.x)
        const_cast<int*>(L1.keys)[b0 + i] = tk[i];
      if (t == 0) {
        L1.fix[g] = gr_fix(tk, nc, b0, edge[0], after1, 0);
        L1.tail_keys[g] = tk[nc - 1];
      }
    }
    __syncthreads();
  }
}

// Levels l and l + 1, up, once level l + 2's sums are final (out2): warp
// q of block g fixes level l's chunks 32g + q + 8i (i < 4) that have a
// fix word, each from level l + 1's final sum at entry e (the chunk, or
// the one before): its down fold, itself fixed where the fix word of
// level l + 1's chunk g (or, at e = 32g - 1, chunk g - 1) lands on e.
__global__ void __launch_bounds__(TRT_GR_UP_WARPS * 32)
gather_rows_up_kernel(GrLevel L, GrLevel L1, const float* __restrict__ out2,
                      int w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x, b0 = g * TRT_GR_CHUNK;
  const int nc = min(TRT_GR_CHUNK, L1.m - b0);
  constexpr int kPer = TRT_GR_CHUNK / TRT_GR_UP_WARPS;
  int x = -1;
  if (lane < kPer && warp + lane * TRT_GR_UP_WARPS < nc)
    x = L.fix[b0 + warp + lane * TRT_GR_UP_WARPS];
  if (lane == kPer) x = L1.fix[g];
  if (lane == kPer + 1 && g > 0) x = L1.fix[g - 1];
  const int fx1 = __shfl_sync(TRT_GR_FULL, x, kPer);
  const int fx0 = __shfl_sync(TRT_GR_FULL, x, kPer + 1);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int fx = __shfl_sync(TRT_GR_FULL, x, i);
    if (fx < 0) continue;
    const int b = b0 + warp + i * TRT_GR_UP_WARPS;
    const int e = (fx & 1) ? b : b - 1;
    const int f = (fx1 >= 0 && (fx1 >> 1) == e) ? fx1
                  : (fx0 >= 0 && (fx0 >> 1) == e) ? fx0 : -1;
    // level l + 1's chunk of entry e: g, or g - 1 at e = 32g - 1
    const int b1 = e >= b0 ? g : g - 1;
    for (int c = lane; c < w; c += 32) {
      float u = L1.out[(size_t)e * w + c];
      if (f >= 0)
        u = (f & 1) ? out2[(size_t)b1 * w + c]
                    : out2[(size_t)(b1 - 1) * w + c] + u;
      gr_fix_col(L.out, w, fx, c, u);
    }
  }
}

// Levels l0 .. levels - 1 (at most TRT_GR_TOP_MAX entries at l0), down
// and up, in one block: thread i takes (chunk, column) i, i + blockDim,
// ... of a level.
__global__ void __launch_bounds__(TRT_GR_TOP_THREADS)
gather_rows_top_kernel(GrLevels P, int l0, int levels, int w) {
  __shared__ int sk[TRT_GR_TOP_MAX];
  for (int l = l0; l < levels; ++l) {
    const GrLevel L = P.lv[l];
    const int nb = (L.m + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    for (int j = threadIdx.x; j < L.m; j += blockDim.x) sk[j] = L.keys[j];
    __syncthreads();
    for (int i = threadIdx.x; i < nb * w; i += blockDim.x) {
      const int b = i / w, c = i - b * w, base = b * TRT_GR_CHUNK;
      const int cnt = min(TRT_GR_CHUNK, L.m - base);
      const int after = base + cnt < L.m ? sk[base + cnt] : -1;
      gr_fold_col(sk + base, L.ids ? L.ids + base : nullptr, cnt, base,
                  L.vals + c, w, after, L.out + c, w, L.by_key, base,
                  L.tail_vals ? L.tail_vals + (size_t)b * w + c : nullptr);
      if (c == 0) {
        L.fix[b] = gr_fix(sk + base, cnt, base, b ? sk[base - 1] : -1, after,
                          L.by_key);
        if (L.tail_keys) L.tail_keys[b] = sk[base + cnt - 1];
      }
    }
    __syncthreads();
  }
  for (int l = levels - 2; l >= l0; --l) {
    const GrLevel L = P.lv[l];
    const float* up = P.lv[l + 1].out;
    const int nb = (L.m + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    for (int i = threadIdx.x; i < nb * w; i += blockDim.x) {
      const int b = i / w, c = i - b * w;
      const int fx = L.fix[b];
      if (fx >= 0)
        gr_fix_col(L.out, w, fx, c,
                   up[(size_t)((fx & 1) ? b : b - 1) * w + c]);
    }
    __syncthreads();
  }
}

// The entry counts of levels 0.. (m[0] = r) -> the number of levels.
int gr_levels(int r, int* m) {
  int levels = 1;
  m[0] = r;
  while (m[levels - 1] > TRT_GR_CHUNK && levels < TRT_GR_MAX_LEVELS) {
    m[levels] = (m[levels - 1] + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    ++levels;
  }
  return levels;
}

long long gr_chunks(int m) { return (m + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK; }

// int32 words of the fold's scratch: each level's fix words, and each
// level above 0 its keys, vals and run-end folds.
long long gr_fold_words(int r, int w) {
  int m[TRT_GR_MAX_LEVELS];
  const int levels = gr_levels(r, m);
  long long words = 0;
  for (int l = 0; l < levels; ++l) {
    words += gr_round4(gr_chunks(m[l]));
    if (l) words += gr_round4(m[l]) + 2 * gr_round4((long long)m[l] * w);
  }
  return words;
}


int gr_fold(const int* keys, const int* ids, const float* g, int r, int w,
            int n, float* d_table, int* scratch, cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(d_table, 0, (size_t)n * w * sizeof(float), stream);
  if (err != cudaSuccess || r == 0) return (int)err;
  int m[TRT_GR_MAX_LEVELS];
  const int levels = gr_levels(r, m);
  if (m[levels - 1] > TRT_GR_CHUNK) return (int)cudaErrorInvalidValue;
  GrLevels P = {};
  int* at = scratch;
  for (int l = 0; l < levels; ++l) {
    int* fix = at;
    at += gr_round4(gr_chunks(m[l]));
    if (l == 0) {
      P.lv[0] = GrLevel{keys, ids, g, d_table, fix, nullptr, nullptr, r, 1};
      continue;
    }
    int* k = at;
    float* v = (float*)(at + gr_round4(m[l]));
    float* o = v + gr_round4((long long)m[l] * w);
    at = (int*)(o + gr_round4((long long)m[l] * w));
    P.lv[l] = GrLevel{k, nullptr, v, o, fix, nullptr, nullptr, m[l], 0};
    P.lv[l - 1].tail_keys = k;
    P.lv[l - 1].tail_vals = v;
  }
  const int wc = w < TRT_GR_COLS ? w : TRT_GR_COLS;
  int l = 0;
  for (; m[l] > TRT_GR_TOP_MAX; l += 2)  // then levels l + 2, l + 3 exist
    gather_rows_down_kernel<<<(m[l] + TRT_GR_GROUP - 1) / TRT_GR_GROUP,
                              TRT_GR_CHUNK * wc, 0, stream>>>(
        P.lv[l], P.lv[l + 1], w);
  gather_rows_top_kernel<<<1, TRT_GR_TOP_THREADS, 0, stream>>>(P, l, levels,
                                                                w);
  for (l -= 2; l >= 0; l -= 2)
    gather_rows_up_kernel<<<(m[l] + TRT_GR_GROUP - 1) / TRT_GR_GROUP,
                            TRT_GR_UP_WARPS * 32, 0, stream>>>(
        P.lv[l], P.lv[l + 1], P.lv[l + 2].out, w);
  return (int)cudaGetLastError();
}

}  // namespace

// int32 words of the scratch of a launch over r lanes of width w into n
// rows (the sort's, then the fold's), or -1 past 2^31 - 1.
extern "C" int trt_gather_rows_scratch(int r, int w, int n) {
  if (r < 0 || w < 1 || n < 1) return -1;
  const long long words = gr_sort_words(r, n) + gr_fold_words(r, w);
  return words > 0x7fffffffll ? -1 : (int)words;
}

// idx [r] int32 -> keys [r] int32 (idx in stable sorted order) and ids
// [r] int32 (the lane of each). scratch: trt_gather_rows_scratch words.
extern "C" int trt_gather_rows_sort(const int* idx, int r, int n, int* keys,
                                    int* ids, int* scratch,
                                    cudaStream_t stream) {
  if (r < 0 || n < 1) return (int)cudaErrorInvalidValue;
  if (r == 0) return (int)cudaSuccess;
  const GrPlan p = gr_plan(r, n);
  if (p.passes == 0) {
    gather_rows_iota_kernel<<<(r + 255) / 256, 256, 0, stream>>>(idx, r,
                                                                 keys, ids);
  } else {
    int* alt = scratch + 2 * gr_round4(r);
    int* counts = scratch + 4 * gr_round4(r);
    const cudaError_t err =
        gr_sort(idx, r, p, keys, ids, alt, alt + gr_round4(r), counts,
                counts + gr_round4((long long)p.digits * p.ntiles), stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// keys, ids [r] int32 (a stable order by key; ids may be null: the lanes
// in order), g [r, w] f32 -> d_table [n, w] f32 (zeroed here).
extern "C" int trt_gather_rows_fold(const int* keys, const int* ids,
                                    const float* g, int r, int w, int n,
                                    float* d_table, int* scratch,
                                    cudaStream_t stream) {
  if (r < 0 || w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  return gr_fold(keys, ids, g, r, w, n, d_table,
                 scratch + gr_sort_words(r, n), stream);
}

// idx [r] int32, g [r, w] f32 -> d_table [n, w] f32: the sort, then the
// fold. scratch: trt_gather_rows_scratch(r, w, n) words, never read
// before it is written.
extern "C" int trt_gather_rows_bwd(const int* idx, const float* g, int r,
                                   int w, int n, float* d_table,
                                   int* scratch, cudaStream_t stream) {
  if (r < 0 || w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const GrPlan p = gr_plan(r, n);
  if (r == 0 || p.passes == 0)
    return gr_fold(idx, nullptr, g, r, w, n, d_table,
                   scratch + gr_sort_words(r, n), stream);
  int* keys = scratch;
  int* ids = scratch + gr_round4(r);
  int* counts = scratch + 4 * gr_round4(r);
  cudaError_t err = gr_sort(idx, r, p, keys, ids, ids + gr_round4(r),
                            ids + 2 * gr_round4(r), counts,
                            counts + gr_round4((long long)p.digits * p.ntiles),
                            stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return gr_fold(keys, ids, g, r, w, n, d_table,
                 scratch + gr_sort_words(r, n), stream);
}
