"""The bf16 control of a fwd+bwd cell, the reference run over the frame in
chunks of pixels.

    python3 benchmark/control_chunked.py --workload bigmesh-fwdbwd \\
        --control 3 --out <dir>

``calibrate.py``'s control hands the bfloat16 reference the whole frame in
one call. In bfloat16 the reference's cull boxes grow by 16 of its ulps
of their magnitude, so on bigmesh's 163,842 triangles a primary ray meets
~2,300 of the 5,124 boxes where in float32 it meets ~7, and the pair
lists of one 1080p call would take ~78 GB. Here the same reference, in
the same precision, takes the frame in chunks of ``CHUNK`` pixels: each
chunk's forward with its winners kept (``reference.trace(keep=True)``),
the MSE's cotangent of the whole image, then each chunk's replay under
autograd, its gradients added to the leaves. That is ``reference.render``'s
own sequence, split by pixel; only the order in which the chunks'
gradients are added differs. The result is compared with the float32
reference by the cell's own check, as ``calibrate.py`` compares its
control. One JSON line a control seed, then the smallest reading of each
number.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# pixels a chunk: a bf16 chunk's pair lists stay under ~3 GB on bigmesh
CHUNK = 1 << 16


def control_fwdbwd_chunked(harness, reference, cell, seeds, device, k=3,
                           chunk=CHUNK):
    """Step k of the reference in bfloat16, chunk by chunk, put in the
    program's place and checked against the float32 reference -> ((ok,
    checks), facts)."""
    dtype = torch.bfloat16
    loop = harness.FwdBwd(cell, seeds, device)
    r, spp, lanes = loop.r, loop.r["spp"], loop.lanes
    sc, (pos, look_at) = loop.ref_scene(dtype, grad=True)
    target = loop.target.to(dtype)
    kw = dict(width=r["width"], height=r["height"], seed=seeds.render,
              max_bounces=r["max_bounces"])
    total = torch.zeros((lanes, 3), dtype=dtype, device=device)
    rays, parts = 0, []
    with torch.no_grad():
        for p0 in range(0, lanes, chunk):
            px = torch.arange(p0, min(p0 + chunk, lanes), device=device)
            n = px.shape[0]
            sample = (k * spp + torch.arange(spp, device=device)
                      ).repeat_interleave(n)
            pix = px.repeat(spp)
            c, rc, rec = reference.trace(sc, pos.detach(), look_at.detach(),
                                         pixel=pix, sample=sample, keep=True,
                                         **kw)
            part = total[p0:p0 + n]
            for j in range(spp):
                part = part + c[j * n:(j + 1) * n]
            total[p0:p0 + n] = part
            rays += int(rc.sum())
            parts.append((p0, n, pix, sample, rec))
    spp_t = torch.tensor(float(spp), dtype=dtype, device=device)
    cs = total.detach().clone().requires_grad_()
    torch.mean(((cs / spp_t).reshape(target.shape) - target) ** 2).backward()
    cot = cs.grad
    for p0, n, pix, sample, rec in parts:
        c, _, _ = reference.trace(sc, pos, look_at, pixel=pix, sample=sample,
                                  hits=rec, **kw)
        torch.sum(c * cot[p0:p0 + n].repeat(spp, 1)).backward()
    img = (total / spp_t).reshape(target.shape).float()
    grads = {n: (None if t.grad is None else t.grad.float())
             for n, t in sc.leaves.items()}
    grads["camera.position"] = pos.grad.float()
    grads["camera.look_at"] = look_at.grad.float()
    loop.release()
    loop.kept = (k, img, rays, grads)
    return loop.check(cell.spec["limits"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 500)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("control_chunked.py: no CUDA device", file=sys.stderr)
        return 2
    from benchmark import harness, reference
    cell = harness.resolve(args.workload, ROOT)
    if cell.traffic["loop"] != "fwdbwd":
        print("control_chunked.py: a fwd+bwd cell only", file=sys.stderr)
        return 2
    lines = []
    for j in range(args.control):
        # calibrate.py's control seeds
        seed = args.first_seed + 1000 + j
        t0 = time.perf_counter()
        (ok, checks), facts = control_fwdbwd_chunked(
            harness, reference, cell, harness.Seeds.of(seed), "cuda")
        rec = dict(kind="control", seed=seed, correct=ok,
                   checks={**facts["numbers"],
                           **{k: c["value"] for k, c in checks.items()}},
                   facts=str(facts), s=round(time.perf_counter() - t0, 1))
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    got = [ln["checks"] for ln in lines]
    summary = dict(kind="summary", workload=args.workload,
                   control={k: min(g[k] for g in got) for k in got[0]}
                   if got else {})
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, args.workload + ".control.jsonl")
        with open(path, "w") as fh:
            fh.writelines(json.dumps(ln) + "\n" for ln in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
