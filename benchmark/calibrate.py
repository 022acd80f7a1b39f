"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload rtweekend-fwdbwd \\
        --seeds 12 --control 3 --seconds 5 --out chiprun_out/calib

For each of ``--seeds`` seeds, one run of the cell with a short window,
each number the check compares (the lower readings: sound runs of the
program). For each of ``--control`` seeds, the control: the reference
computed in bfloat16, the nearest precision below the configuration's
float32, put in the program's place and compared by the same numbers at
the cell's own size (the upper readings). One JSON line a reading, then a
summary: the largest sound reading and the smallest control reading of
each number. All in one process, so the kernels are built once.
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_fwdbwd(harness, reference, check, cell, seeds, device, k=3):
    """The fwd+bwd step k of the bf16 reference against the f32 one."""
    loop = harness.FwdBwd(cell, seeds, device)
    r, spp = loop.r, loop.r["spp"]
    dt = torch.bfloat16
    sc, (pos, look_at) = loop.ref_scene(dt, grad=True)
    target = loop.target.to(dt)
    shape = loop.target.shape

    def cotangent(total):
        cs = total.detach().clone().requires_grad_()
        im = (cs / torch.tensor(float(spp), dtype=dt, device=device)
              ).reshape(shape)
        torch.mean((im - target) ** 2).backward()
        return cs.grad
    total, rays = reference.render(
        sc, pos, look_at, width=r["width"], height=r["height"],
        pixels=torch.arange(loop.lanes, device=device), spp=spp,
        sample_start=k * spp, seed=seeds.render,
        max_bounces=r["max_bounces"], cotangent=cotangent)
    img = (total / torch.tensor(float(spp), dtype=dt, device=device)
           ).reshape(shape).float()
    grads = {n: (None if t.grad is None else t.grad.float())
             for n, t in sc.leaves.items()}
    grads["camera.position"] = pos.grad.float()
    grads["camera.look_at"] = look_at.grad.float()
    loop.release()
    loop.kept = (k, img, rays, grads)
    (ok, checks), facts = loop.check(cell.spec["limits"])
    return ok, checks, facts


def control_pass(harness, reference, check, cell, seeds, device, passes):
    """``passes`` progressive passes of the bf16 reference against the f32
    one: the running mean at the check's pixels from the first pass, and
    the last pass over every pixel, its rays and its mean folded into the
    previous mean, which is the program's own after ``passes - 1`` passes
    (as the check folds the f32 reference's last pass into it)."""
    loop = harness.Pass(cell, seeds, device)
    r, spp = loop.r, loop.r["spp"]
    for p in range(passes - 1):
        loop.step(p)
    prev = loop.state.mean.reshape(-1, 3)
    loop.release()
    n_pick = min(int(cell.traffic["check_pixels"]), loop.lanes)
    pick = np.sort(np.random.default_rng(seeds.pick).choice(
        loop.lanes, n_pick, replace=False))
    px = torch.as_tensor(pick, device=device)
    kw = dict(width=r["width"], height=r["height"], spp=spp,
              seed=seeds.render, max_bounces=r["max_bounces"])
    out = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            sc, (pos, look_at) = loop.ref_scene(dt)
            mean = torch.zeros((n_pick, 3), dtype=dt, device=device)
            for p in range(passes):
                s, _ = reference.render(sc, pos, look_at, pixels=px,
                                        sample_start=p * spp, **kw)
                mean = check.fold(mean, p * spp, s, spp)
            full, rays = reference.render(
                sc, pos, look_at,
                pixels=torch.arange(loop.lanes, device=device),
                sample_start=(passes - 1) * spp, **kw)
            last = check.fold(prev.to(dt), (passes - 1) * spp, full, spp)
            out[dt] = (mean, rays, last)
    f, b = out[torch.float32], out[torch.bfloat16]
    got = dict(history=check.rel_l2(b[0], f[0]), last=check.rel_l2(b[2], f[2]),
               rays=check.rel_gap(b[1], f[1]))
    return check.judge(got, cell.spec["limits"]) + ({},)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 500)
    ap.add_argument("--passes", type=int, default=300,
                    help="passes of the pass cell's control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import check, harness, reference
    cell = harness.resolve(args.workload, ROOT)
    device = "cuda"
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        facts = []
        res = harness.run_cell(cell, seed, args.seconds, False, device,
                               log=facts.append)
        numbers = res["numbers"] if "numbers" in res else {}
        emit(dict(kind="program", seed=seed, correct=res["correct"],
                  checks={**numbers, **{k: c["value"] for k, c in
                                        res["checks"].items()}},
                  attempted=res["attempted"], facts=facts,
                  s=round(time.perf_counter() - t0, 1)))
    for j in range(args.control):
        seed = args.first_seed + 1000 + j
        seeds = harness.Seeds.of(seed)
        t0 = time.perf_counter()
        if cell.traffic["loop"] == "fwdbwd":
            ok, checks, facts = control_fwdbwd(harness, reference, check,
                                               cell, seeds, device)
        else:
            ok, checks, facts = control_pass(harness, reference, check, cell,
                                             seeds, device, args.passes)
        checks.update({k: {"value": v} for k, v in facts.get(
            "numbers", {}).items() if k not in checks})
        emit(dict(kind="control", seed=seed, correct=ok,
                  checks={k: c["value"] for k, c in checks.items()},
                  facts=str(facts), s=round(time.perf_counter() - t0, 1)))
        torch.cuda.empty_cache()
    summary = {}
    for kind, pick in (("program", max), ("control", min)):
        got = [ln["checks"] for ln in lines if ln["kind"] == kind]
        summary[kind] = {k: pick(g[k] for g in got if k in g)
                         for k in (got[0] if got else {})}
    emit(dict(kind="summary", workload=args.workload, **summary))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, args.workload + ".jsonl"), "w") as fh:
            fh.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
