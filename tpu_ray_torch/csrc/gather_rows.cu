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
// The order (mirrored by kernels/gather_rows.py gather_rows_bwd_plain):
// the lanes are put in a stable order by idx (torch.sort(stable=True) in
// the wrapper: sorted keys and lane ids). Level 0 is that sequence of
// (key, g row); it is cut into blocks of TRT_GR_CHUNK consecutive entries.
// - Down pass of a level (gather_rows_down_kernel, one thread a block and
//   column): each run of equal keys inside a block is folded in order from
//   +0.0; the fold at a run's last entry in the block is written out (to
//   d_table[key] on level 0, to the level's own row of that entry above).
//   The block's last entry's key and fold are the block's tail; the tails
//   of all blocks, in block order, are the next level's sequence (still
//   sorted). A level of at most TRT_GR_CHUNK entries is the top.
// - Up pass (gather_rows_up_kernel, top level first): where block b's
//   first run began in an earlier block and ends in block b, its fold
//   covers only block b. The next level holds the run's sum over the
//   earlier blocks (there the run ends at entry b - 1): the run's sum is
//   that + its fold. If the run ends at block b's last entry, the next
//   level's sum at entry b already holds block b's part, and is taken as
//   it is.
// So a run of L entries is summed by a tree of fan-in TRT_GR_CHUNK, whose
// shape depends on the sorted keys alone: 2^21 lanes on one row take five
// levels, each thread folding at most 32 entries.
//
// Bound on the H100: bytes. Each lane's g row (w floats) and its sorted
// key and lane id are read once, d_table written once; the sort's traffic
// comes before it. The down pass of level 0 does all but a 1/32 of the
// work; its threads of one block read w consecutive floats of each row.
// Tables of any n take the same path: a shared-memory table (the sphere
// table's 6 KB) would save nothing but the sort, and one order for every
// shape lets one plain mirror hold the kernel bit for bit.
#include <cuda_runtime.h>

#define TRT_GR_CHUNK 32
#define TRT_GR_THREADS 256
#define TRT_GR_MAX_LEVELS 8

namespace {

// One thread per (block, column) of a level's sequence of m entries:
// keys [m] sorted, values g[perm[j]] (perm given) or vals[j] rows of w.
// Writes each run end's fold to out[row * w + c] (row = the key when
// by_key, else the entry), and the block's tail key and fold when
// tail_keys is given.
__global__ void gather_rows_down_kernel(
    const int* __restrict__ keys, const float* __restrict__ vals,
    const long long* __restrict__ perm, int m, int w,
    float* __restrict__ out, int by_key, int* __restrict__ tail_keys,
    float* __restrict__ tail_vals) {
  const int nb = (m + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)nb * w) return;
  const int b = (int)(tid / w), c = (int)(tid % w);
  const int base = b * TRT_GR_CHUNK;
  const int end = min(base + TRT_GR_CHUNK, m);
  float acc = 0.0f;
  int prev = keys[base];
  for (int j = base; j < end; ++j) {
    const int k = keys[j];
    if (k != prev) {
      out[(size_t)(by_key ? prev : j - 1) * w + c] = acc;
      acc = 0.0f;
      prev = k;
    }
    const size_t row = perm ? (size_t)perm[j] : (size_t)j;
    acc = acc + vals[row * w + c];
  }
  if (end == m || keys[end] != prev)
    out[(size_t)(by_key ? prev : end - 1) * w + c] = acc;
  if (tail_keys) {
    if (c == 0) tail_keys[b] = prev;
    tail_vals[(size_t)b * w + c] = acc;
  }
}

// One thread per (block b >= 1, column) of a level: where block b's first
// run began in an earlier block and ends in block b, add the run's sum
// over the earlier blocks from up, the next level's results (one row an
// entry of that level).
__global__ void gather_rows_up_kernel(const int* __restrict__ keys, int m,
                                      int w, float* __restrict__ out,
                                      int by_key,
                                      const float* __restrict__ up) {
  const int nb = (m + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)(nb - 1) * w) return;
  const int b = 1 + (int)(tid / w), c = (int)(tid % w);
  const int base = b * TRT_GR_CHUNK;
  const int k0 = keys[base];
  if (keys[base - 1] != k0) return;
  const int last = min(base + TRT_GR_CHUNK, m) - 1;
  int p = base;
  while (p < last && keys[p + 1] == k0) ++p;
  if (p + 1 < m && keys[p + 1] == k0) return;   // the run ends further on
  float* o = out + (size_t)(by_key ? k0 : p) * w + c;
  *o = p == last ? up[(size_t)b * w + c] : up[(size_t)(b - 1) * w + c] + *o;
}

// The entry counts of levels 0.. (m[0] = r) -> the number of levels.
int trt_gr_levels(int r, int* m) {
  int levels = 1;
  m[0] = r;
  while (m[levels - 1] > TRT_GR_CHUNK && levels < TRT_GR_MAX_LEVELS) {
    m[levels] = (m[levels - 1] + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    ++levels;
  }
  return levels;
}

int trt_gr_blocks(long long threads) {
  return (int)((threads + TRT_GR_THREADS - 1) / TRT_GR_THREADS);
}

}  // namespace

// Rows of the scratch of a launch over r lanes: the entries of levels 1
// and up (each row a key in skeys, w floats in svals and in sout).
extern "C" int trt_gather_rows_scratch(int r) {
  int m[TRT_GR_MAX_LEVELS];
  const int levels = trt_gr_levels(r, m);
  int rows = 0;
  for (int l = 1; l < levels; ++l) rows += m[l];
  return rows;
}

// keys [r] int32 sorted (stable), perm [r] int64 the lane of each sorted
// entry, g [r, w] f32 -> d_table [n, w] f32 (zeroed here). skeys, svals,
// sout: scratch of trt_gather_rows_scratch(r) rows (int32; w floats; w
// floats), never read before it is written.
extern "C" int trt_gather_rows_bwd(const int* keys, const long long* perm,
                                   const float* g, int r, int w, int n,
                                   float* d_table, int* skeys, float* svals,
                                   float* sout, cudaStream_t stream) {
  if (r < 0 || w < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(d_table, 0, (size_t)n * w * sizeof(float), stream);
  if (err != cudaSuccess || r == 0) return (int)err;
  int m[TRT_GR_MAX_LEVELS];
  const int levels = trt_gr_levels(r, m);
  if (m[levels - 1] > TRT_GR_CHUNK) return (int)cudaErrorInvalidValue;
  size_t off[TRT_GR_MAX_LEVELS + 1];
  off[1] = 0;
  for (int l = 1; l < levels; ++l) off[l + 1] = off[l] + m[l];
  for (int l = 0; l < levels; ++l) {
    const int nb = (m[l] + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    const int* k = l ? skeys + off[l] : keys;
    const float* v = l ? svals + off[l] * w : g;
    float* out = l ? sout + off[l] * w : d_table;
    const bool tails = l + 1 < levels;
    gather_rows_down_kernel<<<trt_gr_blocks((long long)nb * w),
                              TRT_GR_THREADS, 0, stream>>>(
        k, v, l ? nullptr : perm, m[l], w, out, l == 0,
        tails ? skeys + off[l + 1] : nullptr,
        tails ? svals + off[l + 1] * w : nullptr);
  }
  for (int l = levels - 2; l >= 0; --l) {
    const int nb = (m[l] + TRT_GR_CHUNK - 1) / TRT_GR_CHUNK;
    const int* k = l ? skeys + off[l] : keys;
    float* out = l ? sout + off[l] * w : d_table;
    gather_rows_up_kernel<<<trt_gr_blocks((long long)(nb - 1) * w),
                            TRT_GR_THREADS, 0, stream>>>(
        k, m[l], w, out, l == 0, sout + off[l + 1] * w);
  }
  return (int)cudaGetLastError();
}
