"""Time K7 against variants of its tile staging built from patched copies
of the package.

    python -m tpu_ray_torch.tools.k7_variants [--reps 5]

K7 (``csrc/tri_intersect.cu``) stages tiles of 256 triangles
(``TRT_K7_TILE``) between two block barriers, four rays a thread
(``TRT_K7_RAYS``). Each variant (VARIANTS) is a copy of the package under
the git-ignored ``.chip_check/variants/<name>/`` with one change: tiles
of 512 or 1,024 triangles (24 or 48 KB of static shared memory a block,
so fewer blocks an SM), a double buffer of two 256-triangle tiles filled
with ``cp.async`` (the next tile's copy overlaps the fold of this one,
one barrier a tile), or two or eight rays a thread. The copies build at
once, one nvcc each; then each build runs in a process of its own, in
turns (this build, every variant, this build), on trimesh's primary rays
(sample 0) at 320x180 (57,600 rays, the triangle axis split into slices)
and 1920x1080 (2,073,600 rays, one slice), 10,368 triangles. Every
variant must give this build's t and idx bit for bit. One JSON line a
run; the last line is a summary with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from tpu_ray_torch.tools.cull_variants import _build, _copy

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_OUT = os.path.join(_ROOT, ".chip_check", "variants")
SIZES = ((320, 180), (1920, 1080))
SEED = 0

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

# name -> [(file under the package, text, its replacement)]
VARIANTS = {
    "k7 tile 512": [(K7, TILE, "#define TRT_K7_TILE 512\n")],
    "k7 tile 1024": [(K7, TILE, "#define TRT_K7_TILE 1024\n")],
    "k7 cp.async": [(K7, INCLUDE, INCLUDE + "#include <cuda_pipeline.h>\n"),
                    (K7, SHARED, DOUBLE_SHARED), (K7, STAGED, DOUBLE)],
    "k7 rays 2": [(K7, RAYS, "#define TRT_K7_RAYS 2\n")],
    "k7 rays 8": [(K7, RAYS, "#define TRT_K7_RAYS 8\n")],
}


def _child(root: str, name: str, ref_path: str, reps: int) -> dict:
    """K7 of the package under root on trimesh's primary rays at SIZES;
    its outputs are saved to ref_path where it does not exist, else held
    against it."""
    sys.path.insert(0, root)
    import torch

    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene
    from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit,
                                                     tri_slices)
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    dev = torch.device("cuda", 0)
    scene = make_scene("trimesh", device=dev)
    tab = tri_search_table(scene.tris)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    run, outs = dict(run=name), []
    for w, h in SIZES:
        o, d, _ = camera_rays(default_camera(scene), w, h, torch.arange(
            w * h, device=dev), 0, SEED)
        ms = []
        for _ in range(reps + 1):             # the first call warms up
            torch.cuda.synchronize()
            start.record()
            hit = tri_nearest_hit(tab, o, d)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        outs += [hit.t.cpu(), hit.idx.cpu()]
        run[f"{w}x{h}"] = dict(rays=w * h, ms=ms[1:],
                               slices=tri_slices(w * h, tab.shape[0], dev))
    if not os.path.exists(ref_path):
        torch.save(outs, ref_path)
    for got, want in zip(outs, torch.load(ref_path)):
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"{name}: K7's t or idx differ from this "
                               f"build's")
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.reps)), flush=True)
        return 0
    os.makedirs(_OUT, exist_ok=True)
    ref_path = os.path.join(_OUT, "k7_reference.pt")
    if os.path.exists(ref_path):
        os.remove(ref_path)
    roots = {"this build": _ROOT}
    roots.update((name, _copy(name, edits))
                 for name, edits in VARIANTS.items())
    builds = {name: _build(root) for name, root in roots.items()}
    for name, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {name} failed:\n{err[-4000:]}")
    runs = []
    for name in ["this build", *VARIANTS, "this build"]:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_ray_torch.tools.k7_variants",
             "--reps", str(args.reps), "--child", roots[name], name,
             ref_path],
            cwd=roots[name], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the run of {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card}
    for r in runs:
        for w, h in SIZES:
            summary.setdefault(f"{w}x{h}", {}).setdefault(
                r["run"], []).extend(r[f"{w}x{h}"]["ms"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
