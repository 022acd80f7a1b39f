"""Time the fused estimator passes of this build against another
checkout's, in turns.

    python -m tpu_ray_torch.tools.pass_turns --other DIR [--calls 10]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into the git-ignored
``.chip_check/``). Each build runs in a process of its own, in turns (this
build, the other, the other, this build; ``--rounds`` times, after one
process of this build whose numbers are dropped, since a fresh machine's
first process runs slower), the four estimator cells of
``chip_smoke.py`` (sixteen Lambert+shadow 512x512 4 spp, single flat
256x256 1 spp, trimesh flat and trilight Lambert+shadow at 1920x1080
4 spp) and trimesh flat again in four ray chunks, each as the CLI drives
it (``PathTracer.step`` on backend "fused"): two warm-up passes, then
``--calls`` passes timed on the host's clock (from a synchronized device
to a synchronized device), then one pass under ``torch.profiler``, whose
device busy time over the pass's wall time gives the device's idle share,
then one under the profiler's host activity, whose costliest host
operations (self time) each run lists.
The summary counts the pixels where the two builds' images differ (the
triangle lists of one build may pass over a grazing hit that the other
folds). One JSON line a run; the last line is a summary with the card's
name and power limit. Needs a CUDA device.
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
# (name, scene, shading, width, height, spp, ray_chunk)
CELLS = (("sixteen", "sixteen", "lambert_shadow", 512, 512, 4, None),
         ("single", "single", "flat", 256, 256, 1, None),
         ("trimesh flat", "trimesh", "flat", 1920, 1080, 4, None),
         ("trilight", "trilight", "lambert_shadow", 1920, 1080, 4, None),
         ("trimesh flat, 4 chunks", "trimesh", "flat", 1920, 1080, 4,
          1920 * 1080 // 4))
SEED = 0
HOST_TOP = 12


def _child(root: str, build_name: str, out: str, calls: int) -> dict:
    """The cells' passes on the package under root -> their numbers; each
    cell's image is saved under out."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import tpu_ray_torch
    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.core.scene import make_scene, make_trilight_scene

    got = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    if got != os.path.join(root, "tpu_ray_torch"):
        raise RuntimeError(f"imported {got}, not the package under {root}")
    dev = torch.device("cuda", 0)
    run = dict(build=build_name)
    for name, scene, shading, w, h, spp, chunk in CELLS:
        sc = (make_trilight_scene(device=dev) if scene == "trilight"
              else make_scene(scene, device=dev))
        tracer = PathTracer(RenderConfig(
            scene=scene, width=w, height=h, spp=spp, backend="fused",
            seed=SEED, shading=shading, ray_chunk=chunk), scene=sc,
            device=dev)
        secs = []
        for k in range(2 + calls):
            state0 = tracer.init_state()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = tracer.step(state0)
            torch.cuda.synchronize()
            if k >= 2:
                secs.append(time.perf_counter() - t)
        state0 = tracer.init_state()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)     # away from the trace's ends, as chip_smoke
            t = time.perf_counter()
            tracer.step(state0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            time.sleep(0.02)
        busy = sum(e.self_device_time_total / 1e3
                   for e in prof.key_averages())
        # where the host's time goes: one more pass, its host operations
        state0 = tracer.init_state()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tracer.step(state0)
            torch.cuda.synchronize()
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in prof.key_averages()), key=lambda x: -x[1])
        torch.save(state.mean.cpu(), os.path.join(
            out, f"{build_name}_{name}.pt".replace(" ", "_")))
        run[name] = dict(pass_ms=[s * 1e3 for s in secs],
                         profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
                         idle_share=1.0 - busy / 1e3 / wall,
                         host_ms_top=host[:HOST_TOP])
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(*args.child, args.calls)), flush=True)
        return 0
    if not args.other:
        ap.error("--other is required")
    other = os.path.abspath(args.other)
    out = os.path.join(_ROOT, ".chip_check", "pass_turns")
    os.makedirs(out, exist_ok=True)
    runs = []
    order = [(_ROOT, "this build"), (other, "other"), (other, "other"),
             (_ROOT, "this build")]
    for k, (root, name) in enumerate([(_ROOT, "warm-up")]
                                     + order * args.rounds):
        # this file as a script, so that a checkout without it runs too
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--calls",
             str(args.calls), "--child", root, name, out], cwd=root,
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the run of {name} failed:\n"
                               f"{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        if k > 0:
            runs.append(run)
    import torch
    differ = {}
    for cell, *_ in CELLS:
        a, b = (torch.load(os.path.join(out, f"{n}_{cell}.pt"
                                        .replace(" ", "_")))
                for n in ("this build", "other"))
        differ[cell] = int((a != b).any(-1).sum())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"card": card, "pixels_differing": differ}
    for r in runs:
        for cell, *_ in CELLS:
            s = summary.setdefault(cell, {}).setdefault(r["build"], dict(
                pass_ms=[], idle_share=[], device_busy_ms=[]))
            s["pass_ms"] += r[cell]["pass_ms"]
            s["idle_share"].append(r[cell]["idle_share"])
            s["device_busy_ms"].append(r[cell]["device_busy_ms"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
