"""Time K2's listed triangle mode with an ascending fold in its place.

    python -m tpu_ray_torch.tools.fold_order [--reps 3]

K2's listed mode (``csrc/regen.cu``) folds each block's tiles front to
back with an early exit (``common.cuh`` ``trt_fold_tiles_ordered``, K10's
fold). This script copies the package into the git-ignored
``.chip_check/fold_order/`` with that fold replaced by the one K8 ran
before it took this fold too, in ascending tile id over every listed tile
(``trt_block_list`` and ``fold_listed_staged``, which this script adds to
the copy), and times
both builds at trimesh 1920x1080, 2 spp, the triangle route's own state,
in turns (this build, the copy, the copy, this build), one process each: the forward, the recording and
a launch with the counters on. Each process prints one JSON line; the
last line is a summary with the card's name and power limit. Both folds
must end in the same state bit for bit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
INCLUDE = '#include "regen_step.cuh"\n'
# the ascending fold's device functions, which no kernel of the build has:
# the block's tiles listed in ascending id, and the staged fold over them
ASCENDING_FNS = INCLUDE + """
// Shared ints of trt_block_list's scratch for n_tiles tiles: a bit a tile
// in 32-bit vote words, and the words' exclusive prefix of set bits.
__host__ __device__ __forceinline__ int trt_list_scratch(int n_tiles) {
  return 2 * ((n_tiles + 31) / 32) + 1;
}

// The block's list of reachable triangle tiles (kernels/bounce_step.py
// tri_block_lists at block_r = blockDim.x, group 1): tile t is listed if
// the ray (o, d) of an active lane meets its box (box [n_tiles, 6] in
// shared memory). Each warp votes tile by tile and its first lane ORs the
// votes of 32 tiles into a shared word; warp 0 scans the words' popc
// counts with shuffles, and every thread writes its tiles' places, so lst
// holds the reached ids in ascending order. -> the count. Every thread of
// the block calls it (it holds barriers); blockDim.x is a multiple of 32.
// scratch: trt_list_scratch(n_tiles) ints, lst: n_tiles ints, shared.
__device__ __forceinline__ int trt_block_list(bool active, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz,
                                              const float* box, int n_tiles,
                                              int* scratch, int* lst) {
  const int n_words = (n_tiles + 31) >> 5;
  unsigned* words = reinterpret_cast<unsigned*>(scratch);
  int* pre = scratch + n_words;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) words[w] = 0u;
  __syncthreads();
  if (__any_sync(0xffffffffu, active)) {         // uniform in the warp
    const TrtRay ray = trt_ray(ox, oy, oz, dx, dy, dz);
    unsigned bits = 0u;
    for (int t = 0; t < n_tiles; ++t) {
      float tl;
      const bool f = active && trt_slab_entry(ray, box + 6 * t, tl);
      if (__any_sync(0xffffffffu, f)) bits |= 1u << (t & 31);
      if ((t & 31) == 31 || t == n_tiles - 1) {
        if (lane == 0 && bits) atomicOr(words + (t >> 5), bits);
        bits = 0u;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int j0 = 0; j0 < n_words; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < n_words ? __popc(words[j]) : 0;
      int x = c;                                   // inclusive scan
      for (int s = 1; s < 32; s <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, s);
        if (lane >= s) x += y;
      }
      if (j < n_words) pre[j] = carry + x - c;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) pre[n_words] = carry;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const unsigned b = words[t >> 5];
    if ((b >> (t & 31)) & 1u) {
      lst[pre[t >> 5] + __popc(b & ((1u << (t & 31)) - 1u))] = t;
    }
  }
  const int cnt = pre[n_words];
  __syncthreads();
  return cnt;
}

// trt_fold_tris over the tiles lst[0..cnt) in ascending order, each
// staged into shared memory by the whole block (trt_fold_tiles_staged's
// loop over a list). Every thread of the block calls it.
__device__ __forceinline__ void fold_listed_staged(
    const float* __restrict__ tri, int m, int block_m, const int* lst,
    int cnt, float* tile, int id0, bool active, float ox, float oy,
    float oz, float dx, float dy, float dz, float& best, int& bi) {
  for (int k = 0; k < cnt; ++k) {
    const int j0 = lst[k] * block_m;
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
"""
# the listed kernel's fold, and the ascending one in its place (its list
# scratch fits in the ordered list's shared memory for 4 tiles or more)
ORDERED = """\
    const TrtRay ray = trt_ray(L.ox, L.oy, L.oz, L.dx, L.dy, L.dz);
    const int cnt = trt_block_list_ordered(alive, ray, box, gbox, n_tiles,
                                           ord, &s_cnt);
    trt_fold_tiles_ordered(tri, m, block_m, ord, cnt, box, tile, s_wmax, n,
                           alive, ray, best, bi, tested);
"""
ASCENDING = """\
    int* lst = reinterpret_cast<int*>(ord) + trt_list_scratch(n_tiles);
    const int cnt = trt_block_list(alive, L.ox, L.oy, L.oz, L.dx, L.dy,
                                   L.dz, box, n_tiles,
                                   reinterpret_cast<int*>(ord), lst);
    fold_listed_staged(tri, m, block_m, lst, cnt, tile, n, alive, L.ox,
                       L.oy, L.oz, L.dx, L.dy, L.dz, best, bi);
    if (alive) tested += cnt;
"""
WIDTH, HEIGHT, SPP, MAX_BOUNCES, SEED = 1920, 1080, 2, 5, 0


def _child(root: str, fold: str, reps: int) -> dict:
    """Time the listed mode of the package under root -> its numbers."""
    sys.path.insert(0, root)
    import torch

    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene
    from tpu_ray_torch.kernels import build
    from tpu_ray_torch.kernels.bounce_step import tab_tile_boxes
    from tpu_ray_torch.kernels.regen import (regen_record, regen_steps,
                                             regen_tables, wave_init)
    from tpu_ray_torch.models.path_tracer import tile_order

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    build.load()
    dev = torch.device("cuda", 0)
    scene = make_scene("trimesh", device=dev)
    table, tri, _ = regen_tables(scene)
    boxes = tab_tile_boxes(tri)
    perm, _ = tile_order(WIDTH, HEIGHT)
    st0, cam, _ = wave_init(default_camera(scene),
                            torch.as_tensor(perm, device=dev), SPP, SEED, 0,
                            WIDTH, HEIGHT)
    steps = SPP * MAX_BOUNCES
    kw = dict(use_sky=scene.use_sky, max_bounces=MAX_BOUNCES, width=WIDTH,
              height=HEIGHT, tri=tri, boxes=boxes)

    def ms_of(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = []
        for _ in range(reps + 1):        # the first call warms up
            st = st0.clone()
            torch.cuda.synchronize()
            start.record()
            fn(st)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out[1:], st

    fwd, st = ms_of(lambda s: regen_steps(s, cam, table, steps, **kw))
    rec, _ = ms_of(lambda s: regen_record(s, cam, table, steps, steps, **kw))
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    regen_steps(st0.clone(), cam, table, steps, stats=stats, **kw)
    listed, live, tested = stats.tolist()
    if boxes.shape[0] < 4:
        raise ValueError("the ascending copy needs 4 tiles or more")
    return dict(fold=fold, forward_ms=fwd, record_ms=rec,
                listed_tiles=listed, live_block_steps=live,
                pairs_tested=tested, rays=int(st[22].sum().item()),
                state_digest=int(st.view(torch.int32).to(torch.int64)
                                 .sum().item()),
                ptxas=[line.strip() for line in build.build_info["log"]
                       .splitlines() if "regen_list" in line
                       or "registers" in line][-4:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.reps)), flush=True)
        return 0
    with open(os.path.join(_PKG, "csrc", "regen.cu")) as f:
        text = f.read()
    if text.count(ORDERED) != 1 or text.count(INCLUDE) != 1:
        raise RuntimeError("csrc/regen.cu no longer holds the fold this "
                           "script replaces")
    other_root = os.path.join(_ROOT, ".chip_check", "fold_order")
    shutil.rmtree(other_root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(other_root, "tpu_ray_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(os.path.join(other_root, "tpu_ray_torch", "csrc", "regen.cu"),
              "w") as f:
        f.write(text.replace(ORDERED, ASCENDING)
                .replace(INCLUDE, ASCENDING_FNS))
    runs = []
    for root, fold in ((_ROOT, "ordered"), (other_root, "ascending"),
                       (other_root, "ascending"), (_ROOT, "ordered")):
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_ray_torch.tools.fold_order",
             "--reps", str(args.reps), "--child", root, fold], cwd=root,
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the run under {root} failed:\n"
                               f"{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len({r["state_digest"] for r in runs}) != 1:
        raise RuntimeError("the two folds end in different states")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card}
    for r in runs:
        s = summary.setdefault(r["fold"], dict(
            forward_ms=[], record_ms=[], pairs_tested=r["pairs_tested"]))
        s["forward_ms"] += r["forward_ms"]
        s["record_ms"] += r["record_ms"]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
