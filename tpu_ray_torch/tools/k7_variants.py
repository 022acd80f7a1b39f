"""Time the sliced searches, K1 and K7, against another checkout and
against variants built from patched copies of the package.

    python -m tpu_ray_torch.tools.k7_variants [--reps 5] [--other DIR]
        [--variants [NAME ...]] [--paths]

K1 (``csrc/sphere_intersect.cu``) and K7 (``csrc/tri_intersect.cu``) fold
two and four rays a thread and split the primitive axis into slices
merged by a 64-bit (t, id) atomicMin where the ray blocks alone leave the
card idle; K1 folds only the slots with r * r > 0, compacted by each
block as it stages them. Each variant (VARIANTS; ``--variants`` names some, or none,
of them: all by default) is a copy of the package under the git-ignored
``.chip_check/variants/<name>/`` with one change. K7's: tiles of 512 or
1,024 triangles, a double buffer filled with ``cp.async``, two or eight
rays a thread. K1's: the compaction as a small first launch (one block
writes the real slots and their count to device memory, and the search
reads its slice of them) in place of each block's own scan, four or eight
rays a thread, slices of at least 64 slots, the fold's loop unrolled by
two. DIR (``--other``) is the root
of another checkout, for example the parent commit unpacked with ``git
archive`` into the git-ignored ``.chip_check/``. The builds start at
once, one nvcc each; then each build runs in a process of its own, in
turns (this build, the other, every variant, the other, this build,
after a first run of this build that is dropped, since a fresh machine's
first process runs slower), and times with CUDA events (each sample the
mean of 20 launches queued behind a spin of the device, so that the
host's calls do not pace it; beside it the host's time a call, made back
to back):

- K7 on trimesh's primary rays (sample 0) at 320x180 (57,600 rays, the
  triangle axis split into slices) and 1920x1080 (2,073,600 rays, one
  slice), 10,368 triangles;
- K1 at the shape of every path that launches it: the primary rays of
  rtweekend (57,600 x 512 slots, 482 real), trimesh and trilight (57,600
  x 128, one or two real) at 320x180, sixteen at 512x512 (262,144 x 128,
  16 real), and bigmesh's primary and sorted bounce-1 states at
  1920x1080 (2,073,600 x 128, one real; the probe route's tile-ordered
  lanes, captured as ``chip_smoke.py`` phase 30 captures them).

With ``--paths`` each run also profiles each of those paths once, after a
warm-up call (``torch.profiler``: the device time of K1's kernels, its
launches): backend cuda's pass on rtweekend and trimesh at 320x180 4 spp,
bigmesh's pass on fused (the probe route) and its forward+backward step
(``remat="save_hits"``), and the forward+backward steps of the sixteen
(512x512 4 spp) and trilight (320x180 4 spp) Lambert estimators on fused,
whose backward re-runs the eager estimator. Every build must give this
build's t and idx bit for bit. One JSON line a run; the last line is a
summary with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_OUT = os.path.join(_ROOT, ".chip_check", "variants")
SIZES = ((320, 180), (1920, 1080))
SEED = 0
BATCH = 20                # launches a timed sample
# the device's spin ahead of a timed sample (torch.cuda._sleep, cycles):
# long enough for the host to queue the sample's calls behind it
SPIN = 250_000 * BATCH
# K1's kernels as torch.profiler names them (the search, its unpack and
# the first launch of the variant "k1 prepass")
K1_NAMES = ("sphere_nearest_hit_kernel", "trt_unpack_keys_kernel<1>",
            "k1_compact_kernel")

K7 = "csrc/tri_intersect.cu"
TILE = "#define TRT_K7_TILE 256\n"
RAYS = "#define TRT_K7_RAYS 4\n"
INCLUDE = '#include "common.cuh"\n'
SHARED = "  __shared__ float4 tile[3 * TRT_K7_TILE];\n"
# the staging of one tile between two barriers
STAGED = """\
  for (int j0 = j_begin; j0 < j_end; j0 += TRT_K7_TILE) {
    const int cnt = min(TRT_K7_TILE, j_end - j0);
    __syncthreads();     // every thread is done with the previous tile
    for (int q = threadIdx.x; q < cnt; q += TRT_K7_THREADS) {
      const float* w = tri + 9 * (size_t)(j0 + q);
      tile[3 * q] = make_float4(w[0], w[1], w[2], w[3]);
      tile[3 * q + 1] = make_float4(w[4], w[5], w[6], w[7]);
      tile[3 * q + 2] = make_float4(w[8], 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
"""
# two buffers: tile k + 1 is copied (cp.async, 4 B a float, into the
# 12-float rows) while tile k is folded; the one barrier a tile both
# publishes tile k and frees the buffer tile k + 1 lands in
DOUBLE_SHARED = "  __shared__ float4 tiles[2][3 * TRT_K7_TILE];\n"
DOUBLE = """\
  auto stage = [&](float4* buf, int j0) {
    float* dst = reinterpret_cast<float*>(buf);
    const int n = 9 * min(TRT_K7_TILE, j_end - j0);
    for (int e = threadIdx.x; e < n; e += TRT_K7_THREADS) {
      __pipeline_memcpy_async(dst + 12 * (e / 9) + e % 9,
                              tri + 9 * (size_t)j0 + e, 4);
    }
    __pipeline_commit();
  };
  if (j_begin < j_end) stage(tiles[0], j_begin);
  int cur = 0;
  for (int j0 = j_begin; j0 < j_end; j0 += TRT_K7_TILE, cur ^= 1) {
    const int cnt = min(TRT_K7_TILE, j_end - j0);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (j0 + TRT_K7_TILE < j_end) stage(tiles[cur ^ 1], j0 + TRT_K7_TILE);
    const float4* tile = tiles[cur];
"""

K1 = "csrc/sphere_intersect.cu"
K1_RAYS = "#define TRT_K1_RAYS 2\n"
K1_SLICE = "#define TRT_K1_MIN_SLICE 128\n"
# the compaction as a first launch: one block of 1,024 threads writes the
# real slots (r * r > 0) in ascending order, with their ids, and their
# count to device memory
K1_SQUARE = ("__device__ __forceinline__ float k1_square(float r) { "
             "return r * r; }\n")
K1_PREPASS = K1_SQUARE + """
#define K1_MAX_SLOTS 16384
__device__ float4 k1_table[K1_MAX_SLOTS];
__device__ int k1_ids[K1_MAX_SLOTS];
__device__ int k1_count;

__global__ void k1_compact_kernel(const float* __restrict__ center,
                                  const float* __restrict__ radius, int n) {
  __shared__ int wc[32];
  __shared__ int base;
  if (threadIdx.x == 0) base = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < n; j0 += 1024) {
    const int j = j0 + threadIdx.x;
    const float r2 = j < n ? k1_square(radius[j]) : 0.0f;
    const bool real = r2 > 0.0f;
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (lane == 0) wc[warp] = __popc(mask);
    __syncthreads();
    int place = base + __popc(mask & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < 32; ++w) {
      place += w < warp ? wc[w] : 0;
      total += wc[w];
    }
    if (real) {
      k1_table[place] = make_float4(center[3 * j], center[3 * j + 1],
                                    center[3 * j + 2], r2);
      k1_ids[place] = j;
    }
    __syncthreads();
    if (threadIdx.x == 0) base += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) k1_count = base;
}
"""
# each block's count and scan, replaced by reads of the first launch's
K1_SCAN_START = ("  // the real slots, counted; this block's slice of them "
                 "[b0, b1)\n")
K1_SCAN_END = ("    // ops/intersect.py nearest_hit over the tile, in ascending "
               "id")
K1_READ = """\
  const int c = k1_count;
  const int per = (c + gridDim.y - 1) / gridDim.y;
  const int b0 = min(c, (int)blockIdx.y * per), b1 = min(c, b0 + per);
  for (int lo = b0; lo < b1; lo += TRT_K1_TILE) {
    const int hi = min(b1, lo + TRT_K1_TILE);
    __syncthreads();     // every thread is done with the previous tile
    for (int q = threadIdx.x; q < hi - lo; q += TRT_K1_THREADS) {
      sph[q] = k1_table[lo + q];
      ids[q] = k1_ids[lo + q];
    }
    __syncthreads();
"""
K1_LAUNCH = "  if (slices == 1) {\n    sphere_nearest_hit_kernel<false>"
# the fold's loop over a tile's spheres
K1_FOLD = "    for (int q = 0; q < cnt; ++q) {\n      const float4 s = sph[q];\n"
K1_LAUNCH_PREPASS = ("  k1_compact_kernel<<<1, 1024, 0, stream>>>(center, "
                     "radius, n);\n" + K1_LAUNCH)

# name -> [(file under the package, text, its replacement)]; a text None
# is K1's scan (K1_SCAN_START up to K1_SCAN_END)
VARIANTS = {
    "k7 tile 512": [(K7, TILE, "#define TRT_K7_TILE 512\n")],
    "k7 tile 1024": [(K7, TILE, "#define TRT_K7_TILE 1024\n")],
    "k7 cp.async": [(K7, INCLUDE, INCLUDE + "#include <cuda_pipeline.h>\n"),
                    (K7, SHARED, DOUBLE_SHARED), (K7, STAGED, DOUBLE)],
    "k7 rays 2": [(K7, RAYS, "#define TRT_K7_RAYS 2\n")],
    "k7 rays 8": [(K7, RAYS, "#define TRT_K7_RAYS 8\n")],
    "k1 prepass": [(K1, K1_SQUARE, K1_PREPASS), (K1, None, K1_READ),
                   (K1, K1_LAUNCH, K1_LAUNCH_PREPASS)],
    "k1 rays 4": [(K1, K1_RAYS, "#define TRT_K1_RAYS 4\n")],
    "k1 rays 8": [(K1, K1_RAYS, "#define TRT_K1_RAYS 8\n")],
    "k1 slice 64": [(K1, K1_SLICE, "#define TRT_K1_MIN_SLICE 64\n")],
    "k1 unroll 2": [(K1, K1_FOLD, "#pragma unroll 2\n" + K1_FOLD)],
}


def _edits(edits):
    """VARIANTS' edits with K1's scan (text None) cut out of the source as
    it stands, for cull_variants._copy."""
    out = []
    for rel, old, new in edits:
        if old is None:
            with open(os.path.join(_PKG, rel)) as f:
                text = f.read()
            a, e = text.find(K1_SCAN_START), text.find(K1_SCAN_END)
            if a < 0 or e < a:
                raise RuntimeError(f"{rel} no longer holds K1's scan")
            old = text[a:text.rfind("\n", 0, e) + 1]
        out.append((rel, old, new))
    return out


def _events_ms(torch, fn, reps: int):
    """reps samples of fn's device ms, each the mean of BATCH calls (CUDA
    events) queued behind a spin of the device, so that the host's calls
    do not pace it, after a warm-up call; and the host's ms a call, the
    mean of BATCH calls made back to back."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out, host = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        start.record()
        t0 = time.perf_counter()
        for _ in range(BATCH):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / BATCH)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / BATCH)
    return out, host


def _k1_shapes(torch, dev):
    """{name: (center, radius, origin, direction)} of every path's K1
    launch."""
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene, make_trilight_scene
    from tpu_ray_torch.models.path_tracer import (probe_for, tile_order,
                                                  trace_rays)
    from tpu_ray_torch.ops.raygen import camera_rays

    shapes = {}
    for name, w, h in (("rtweekend", 320, 180), ("trimesh", 320, 180),
                       ("trilight", 320, 180), ("sixteen", 512, 512)):
        sc = (make_trilight_scene(device=dev) if name == "trilight"
              else make_scene(name, device=dev))
        o, d, _ = camera_rays(default_camera(sc), w, h,
                              torch.arange(w * h, device=dev), 0, SEED)
        shapes[f"{name} {w}x{h}"] = (sc.center, sc.radius, o, d)
    big = make_scene("bigmesh", device=dev)
    perm, _ = tile_order(1920, 1080)
    pixel = torch.as_tensor(perm, device=dev)
    states = []
    pf = probe_for(big, "cuda")

    def recording(sc, o, d, alive=None, tape=None):
        states.append((o.clone(), d.clone()))
        return pf(sc, o, d, alive, tape)

    with torch.no_grad():
        o0, d0, base0 = camera_rays(default_camera(big), 1920, 1080, pixel,
                                    0, SEED)
        trace_rays(big, o0, d0, base0, 5, recording)
    for b, name in ((0, "primary"), (1, "bounce 1")):
        shapes[f"bigmesh {name}"] = (big.center, big.radius) + states[b]
    return shapes


def _k1_paths(torch, dev):
    """{path: (fn, K1 launches a call)}: each path as a user drives it."""
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import (make_scene, make_trilight_scene,
                                          trainable_scene)
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.ops.shading_modes import scene_light_indices

    def cuda_pass(name):
        sc = make_scene(name, device=dev)
        return lambda: render_pass(sc, default_camera(sc), width=320,
                                   height=180, spp=4, backend="cuda",
                                   seed=SEED)

    big = make_scene("bigmesh", device=dev)

    def big_step():
        sc, cm = trainable_scene(big), trainable_camera(default_camera(big))
        img = render_mean(sc, cm, width=1920, height=1080, spp=1, seed=SEED,
                          max_bounces=5, backend="fused", remat="save_hits")
        image_mse(img, torch.zeros_like(img)).backward()

    def est_step(sc, w, h):
        lights = scene_light_indices(sc)

        def step():
            tsc = trainable_scene(sc)
            tcam = trainable_camera(default_camera(sc))
            img, _ = render_pass(tsc, tcam, width=w, height=h, spp=4,
                                 backend="fused", seed=SEED,
                                 shading="lambert_shadow", lights=lights)
            image_mse(img, torch.zeros_like(img)).backward()
        return step

    return {
        "rtweekend, backend cuda": cuda_pass("rtweekend"),
        "trimesh, backend cuda": cuda_pass("trimesh"),
        "bigmesh pass": lambda: render_pass(
            big, default_camera(big), width=1920, height=1080, spp=1,
            backend="fused", seed=SEED),
        "bigmesh fwd+bwd step": big_step,
        "sixteen, estimator backward": est_step(
            make_scene("sixteen", device=dev), 512, 512),
        "trilight, estimator backward": est_step(
            make_trilight_scene(device=dev), 320, 180)}


def _child(root: str, name: str, ref_path: str, reps: int,
           paths: bool) -> dict:
    """K1 and K7 of the package under root at their paths' shapes; their
    outputs are saved to ref_path where it does not exist, else held
    against it."""
    sys.path.insert(0, root)
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene
    from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
    from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit,
                                                     tri_slices)
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    warnings.simplefilter("ignore")       # the estimators' fallback notes
    dev = torch.device("cuda", 0)
    scene = make_scene("trimesh", device=dev)
    tab = tri_search_table(scene.tris)
    run, outs = dict(run=name), []
    for w, h in SIZES:
        o, d, _ = camera_rays(default_camera(scene), w, h, torch.arange(
            w * h, device=dev), 0, SEED)
        hit = tri_nearest_hit(tab, o, d)
        outs += [hit.t.cpu(), hit.idx.cpu()]
        ms, host = _events_ms(torch, lambda: tri_nearest_hit(tab, o, d), reps)
        run[f"k7 {w}x{h}"] = dict(
            rays=w * h, slices=tri_slices(w * h, tab.shape[0], dev), ms=ms,
            host_ms=host)
    for key, (c, r, o, d) in _k1_shapes(torch, dev).items():
        hit = sphere_nearest_hit(c, r, o, d)
        outs += [hit.t.cpu(), hit.idx.cpu()]
        ms, host = _events_ms(torch, lambda: sphere_nearest_hit(c, r, o, d),
                              reps)
        run[f"k1 {key}"] = dict(
            rays=o.shape[0], slots=c.shape[0],
            real_slots=int((r * r > 0).sum()), ms=ms, host_ms=host)
    if paths:
        for key, fn in _k1_paths(torch, dev).items():
            fn()
            torch.cuda.synchronize()
            before = sphere_nearest_hit.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ms = sum(e.self_device_time_total / 1e3
                     for e in prof.key_averages()
                     if any(n in e.key for n in K1_NAMES))
            run[f"path {key}"] = dict(
                ms=[ms], launches=sphere_nearest_hit.launches - before)
    if not os.path.exists(ref_path):
        torch.save(outs, ref_path)
    for got, want in zip(outs, torch.load(ref_path)):
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"{name}: K1's or K7's t or idx differ from "
                               f"this build's")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--other", help="the root of another checkout")
    ap.add_argument("--variants", nargs="*", help="the variants to build "
                    "(all by default; none when given no name)")
    ap.add_argument("--paths", action="store_true",
                    help="also profile each path that launches K1")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.reps, args.paths)),
              flush=True)
        return 0
    # the parent process only: a child imports the package it measures
    from tpu_ray_torch.tools.cull_variants import _build, _copy
    names = list(VARIANTS) if args.variants is None else args.variants
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    os.makedirs(_OUT, exist_ok=True)
    ref_path = os.path.join(_OUT, "k1_k7_reference.pt")
    if os.path.exists(ref_path):
        os.remove(ref_path)
    roots = {"this build": _ROOT}
    if args.other:
        roots["other"] = os.path.abspath(args.other)
    roots.update((name, _copy(name, _edits(VARIANTS[name])))
                 for name in names)
    builds = {name: _build(root) for name, root in roots.items()}
    for name, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {name} failed:\n{err[-4000:]}")
    other = ["other"] if args.other else []
    runs = []
    # the first process of a fresh machine runs slower: a run of this
    # build ahead of the turns, dropped from the summary
    order = ["this build", "this build", *other, *names, *other,
             "this build"]
    for turn, name in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--reps",
               str(args.reps), "--child", roots[name], name, ref_path]
        proc = subprocess.run(cmd + (["--paths"] if args.paths else []),
                              cwd=roots[name], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the run of {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        if turn:
            runs.append(run)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card}
    for r in runs:
        for key, rec in r.items():
            if key != "run":
                summary.setdefault(key, {}).setdefault(
                    r["run"], []).extend(rec["ms"])
                if "host_ms" in rec:
                    summary.setdefault(f"{key}, host ms a call",
                                       {}).setdefault(
                        r["run"], []).extend(rec["host_ms"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
