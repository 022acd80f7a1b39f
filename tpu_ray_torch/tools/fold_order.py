"""Time K2's listed triangle mode with an ascending fold in its place.

    python -m tpu_ray_torch.tools.fold_order [--reps 3]

K2's listed mode (``csrc/regen.cu``) folds each block's tiles front to
back with an early exit (``common.cuh`` ``trt_fold_tiles_ordered``, K10's
fold). This script copies the package into the git-ignored
``.chip_check/fold_order/`` with that fold replaced by the one K8 ran
before it took this fold too, in ascending tile id over every listed tile
(``trt_block_list`` and ``trt_fold_tiles_staged``, K9's fold), and times
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
    trt_fold_tiles_staged(tri, m, block_m, lst, cnt, tile, n, alive, L.ox,
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
    if text.count(ORDERED) != 1:
        raise RuntimeError("csrc/regen.cu no longer holds the fold this "
                           "script replaces")
    other_root = os.path.join(_ROOT, ".chip_check", "fold_order")
    shutil.rmtree(other_root, ignore_errors=True)
    shutil.copytree(_PKG, os.path.join(other_root, "tpu_ray_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(os.path.join(other_root, "tpu_ray_torch", "csrc", "regen.cu"),
              "w") as f:
        f.write(text.replace(ORDERED, ASCENDING))
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
