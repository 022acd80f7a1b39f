"""Time K11 (the payload gathers' backward, ``kernels/gather_rows``) of
this build against another checkout's, in turns.

    python -m tpu_ray_torch.tools.k11_turns --other DIR [--rounds 1]
        [--reps 10]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into the git-ignored
``.chip_check/``). Both builds run at once, one nvcc each. This build then
records the inputs, under the git-ignored ``.chip_check/k11_turns/``:

- bigmesh at 1920x1080, 1 spp, as ``chip_smoke.py`` phase 30b takes them:
  the sphere and triangle winners of sample 0's primary rays and of its
  sorted bounce-1 state (the probe route's own states), all lanes on row 0
  of the triangle table and of a one-row table, each with a cotangent
  from a seeded generator;
- every K11 call of one forward+backward step of the sixteen estimator
  (Lambert + shadow, 512x512, 4 spp) and of the trilight one (320x180,
  4 spp), ``image_mse(render_pass(..., backend="fused"), 0).backward()``,
  its idx and cotangent as the step gave them.

Then each build runs in a process of its own, in turns: this build, the
other, the other, this build, ``--rounds`` times. A run times, after one
warm-up call each:

- ``gather_rows_bwd`` on every bigmesh input: the mean of ``--reps``
  calls back to back, by CUDA events;
- each estimator call the same way, queued behind a spin of the device so
  that the host's cost of a call does not pace it;
- three bigmesh forward+backward steps (``render_mean(..., backend=
  "fused", remat="save_hits")``, ``image_mse`` against 0): each step's
  wall seconds, and the sum over the step's K11 calls of each call's
  device interval (CUDA events recorded around it in the step, so a
  library sort inside the call counts); then one step under
  ``torch.profiler``: the device ms of the kernels named ``gather_rows``
  (this build's sort included; a library sort, named by its library, is
  not), and of every kernel of the step whose name holds "sort" or
  "Radix" (the route's own sorts and a library sort inside K11).

Every run saves its d_tables; the summary says whether each build's are
bit-equal to this build's. One JSON line a run; the last line is a
summary with the card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_OUT = os.path.join(_ROOT, ".chip_check", "k11_turns")
BIG = ("bigmesh", 1920, 1080, 1)
SIXTEEN = ("sixteen", "lambert_shadow", 512, 512, 4)
TRILIGHT = ("trilight", "lambert_shadow", 320, 180, 4)
MAX_BOUNCES, SEED, STEPS = 5, 0, 3


def _build(root: str) -> subprocess.Popen:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tpu_ray_torch.kernels import build; build.build()")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _inputs(path: str) -> None:
    """Record the inputs of the turns into path (this build's process)."""
    sys.path.insert(0, _ROOT)
    import torch

    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import (make_scene, make_trilight_scene,
                                          trainable_scene)
    from tpu_ray_torch.grad import image_mse
    from tpu_ray_torch.kernels import gather_rows
    from tpu_ray_torch.kernels.bounce_step import tri_tile_boxes
    from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
    from tpu_ray_torch.kernels.tri_intersect import tri_nearest_hit_stream
    from tpu_ray_torch.models.path_tracer import (probe_for, render_pass,
                                                  tile_order, trace_rays)
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.ops.shading_modes import scene_light_indices

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    name, w, h, _ = BIG
    big = make_scene(name, device=dev)
    cam = default_camera(big)
    perm, _ = tile_order(w, h)
    px = torch.as_tensor(perm, device=dev)
    r = px.shape[0]
    states = []
    pf = probe_for(big, "cuda")

    def recording(sc, o, d, alive=None, tape=None):
        states.append((o.clone(), d.clone(), alive.clone()))
        return pf(sc, o, d, alive, tape)

    with torch.no_grad():
        o0, d0, base0 = camera_rays(cam, w, h, px, 0, SEED)
        trace_rays(big, o0, d0, base0, MAX_BOUNCES, recording)
    tab, boxes = tri_search_table(big.tris), tri_tile_boxes(big.tris)
    big_in = []
    for b in (0, 1):
        o, d, al = states[b]
        big_in += [
            (f"bounce {b}, spheres",
             sphere_nearest_hit(big.center, big.radius, o, d).idx,
             big.n_pad, 12),
            (f"bounce {b}, triangles",
             tri_nearest_hit_stream(tab, boxes, o, d, al).idx,
             big.tris.n_pad, 17)]
    zeros = torch.zeros(r, dtype=torch.int32, device=dev)
    big_in += [("all lanes on row 0, triangles", zeros, big.tris.n_pad, 17),
               ("all lanes on row 0, a one-row table", zeros, 1, 12)]
    saved = {"bigmesh": [
        (what, idx, torch.randn((r, wd), generator=gen, device=dev), n)
        for what, idx, n, wd in big_in]}

    real = gather_rows.gather_rows_bwd
    for key, (scene, shading, ew, eh, spp) in (("sixteen", SIXTEEN),
                                               ("trilight", TRILIGHT)):
        sc = (make_trilight_scene(device=dev) if scene == "trilight"
              else make_scene(scene, device=dev))
        calls = []

        def rec(idx, g, n):
            calls.append((f"call {len(calls)}", idx.clone(), g.clone(), n))
            return real(idx, g, n)

        rec.launches = 0       # the wrapper counts on its module's name

        gather_rows.gather_rows_bwd = rec
        try:
            img, _ = render_pass(trainable_scene(sc),
                                 trainable_camera(default_camera(sc)),
                                 width=ew, height=eh, spp=spp, seed=SEED,
                                 backend="fused", shading=shading,
                                 lights=scene_light_indices(sc))
            image_mse(img, torch.zeros_like(img)).backward()
        finally:
            gather_rows.gather_rows_bwd = real
        if not calls:
            raise RuntimeError(f"the {key} step made no K11 call")
        saved[key] = calls
    torch.save(saved, path)


def _child(root: str, name: str, reps: int) -> dict:
    """One run of the checkout under root -> its numbers; its d_tables
    saved under _OUT."""
    sys.path.insert(0, root)
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpu_ray_torch
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import make_scene, trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.kernels import gather_rows

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    dev = torch.device("cuda", 0)
    inputs = torch.load(os.path.join(_OUT, "inputs.pt"))
    bwd = gather_rows.gather_rows_bwd
    run, outs = dict(run=name), {}

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def back_to_back(fn):
        fn()
        a, b = events()
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def queued(fn):
        fn()
        a, b = events()
        torch.cuda.synchronize()
        torch.cuda._sleep(250_000 * reps)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for cell, calls in inputs.items():
        timer = back_to_back if cell == "bigmesh" else queued
        for what, idx, g, n in calls:
            key = f"{cell}: {what}"
            outs[key] = bwd(idx, g, n)
            run[key] = dict(ms=timer(lambda: bwd(idx, g, n)),
                            lanes=idx.shape[0], rows=n, width=g.shape[1])

    scene, w, h, spp = BIG
    big = make_scene(scene, device=dev)
    cam = default_camera(big)
    spans = []

    def timed_bwd(idx, g, n):
        a, b = events()
        a.record()
        d = bwd(idx, g, n)
        b.record()
        spans.append((a, b))
        return d

    timed_bwd.launches = 0

    def step():
        sc, cm = trainable_scene(big), trainable_camera(cam)
        img = render_mean(sc, cm, width=w, height=h, spp=spp, seed=SEED,
                          max_bounces=MAX_BOUNCES, backend="fused",
                          remat="save_hits")
        image_mse(img, torch.zeros_like(img)).backward()
        return sc.leaf("tris.albedo").grad

    step()
    walls, k11_ms = [], []
    gather_rows.gather_rows_bwd = timed_bwd
    try:
        for _ in range(STEPS):
            spans.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            k11_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        calls = len(spans)
    finally:
        gather_rows.gather_rows_bwd = bwd
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_key = {e.key: e.self_device_time_total / 1e3
              for e in prof.key_averages() if e.self_device_time_total > 0}
    run["bigmesh fwd+bwd step"] = dict(
        step_s=walls, k11_calls=calls, k11_call_spans_ms=k11_ms,
        k11_kernels_ms=sum(v for k, v in by_key.items()
                           if "gather_rows" in k),
        device_ms=sum(by_key.values()),
        sort_kernels_ms=sum(v for k, v in by_key.items()
                            if "sort" in k.lower() or "Radix" in k))
    torch.save({k: v.cpu() for k, v in outs.items()},
               os.path.join(_OUT, name.replace(" ", "_") + ".pt"))
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.inputs:
        _inputs(args.inputs)
        return 0
    if args.child:
        print(json.dumps(_child(*args.child, args.reps)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("k11_turns needs a CUDA device")
    os.makedirs(_OUT, exist_ok=True)
    roots = {"this build": _ROOT, "other": os.path.abspath(args.other)}
    builds = {n: _build(r) for n, r in roots.items()}
    for n, proc in builds.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"the build of {n} failed:\n{err[-4000:]}")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--inputs",
                    os.path.join(_OUT, "inputs.pt")], cwd=_ROOT, check=True)
    names = list(roots)
    runs = []
    for name in (names + names[::-1]) * args.rounds:
        # this file as a script, so that a checkout without it runs too
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--reps",
             str(args.reps), "--child", roots[name], name],
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
    saved = {n: torch.load(os.path.join(_OUT, n.replace(" ", "_") + ".pt"))
             for n in names}
    summary = {"card": card, "bits_equal_to_this_build": {
        name: all(torch.equal(v.view(torch.int32),
                              saved["this build"][k].view(torch.int32))
                  for k, v in saved[name].items())
        for name in names if name != "this build"}}
    for r in runs:
        for key, v in r.items():
            if key == "run":
                continue
            s = summary.setdefault(key, {}).setdefault(r["run"], {})
            for field in ("ms", "step_s", "k11_call_spans_ms",
                          "k11_kernels_ms", "sort_kernels_ms", "k11_calls"):
                if field in v:
                    s.setdefault(field, []).extend(
                        v[field] if isinstance(v[field], list)
                        else [v[field]])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
