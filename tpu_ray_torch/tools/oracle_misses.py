"""Where a route of the port and the native oracle part: which pixels,
which sample, which bounce, and why.

    python -m tpu_ray_torch.tools.oracle_misses --scene trimesh \\
        --width 320 --height 180 --spp 2 --route regen
    python -m tpu_ray_torch.tools.oracle_misses --device cpu \\
        --scene rtweekend --width 64 --height 48 --spp 2 --route torch \\
        --own-basis

Renders the route and the oracle (``oracle/native.py``) one sample at a
time with max_bounces 1..N, given the route's camera basis unless
``--own-basis`` (the oracle's own, reciprocal roots), and prints, for
every pixel past 2e-3 in the full render, the sample and the first
max_bounces at which it parts, and each (sample, max_bounces) pass's
rays on both sides. Then it traces each such lane bounce by bounce on
the host, on the device's camera bits: the eager route (``probe``, the
triangle's edges, as the oracle) beside the per-sample fused route's plain
version (K4's or K8's, the triangle's plane form), each bounce's winners
(unpermuted ids), whether the two rays are the same bits, and where the
winners differ the f64 barycentrics and t of each winning triangle under
both rays. Prints what it finds; checks nothing.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.bounce_step import (bounce_fwd_list_plain,
                                               bounce_fwd_plain,
                                               fused_tables, init_state,
                                               morton_perm, origin_bound,
                                               tri_morton_perm)
from tpu_ray_torch.models.path_tracer import probe, render_pass
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.ops.shade import scatter_direction
from tpu_ray_torch.oracle.native import NativeOracle

ROUTES = {"regen": dict(backend="fused", regen=True),
          "sample": dict(backend="fused", regen=False),
          "cuda": dict(backend="cuda"), "torch": dict(backend="torch")}
OFF = 2e-3


def _bary(tris, j, o, d):
    """f64 (u, v, 1 - u - v, t) of triangle j under the ray (o, d)."""
    v0, e1, e2 = (getattr(tris, k)[j].double() for k in ("v0", "e1", "e2"))
    o, d = o.double(), d.double()
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum()
    tv = o - v0
    q = torch.linalg.cross(tv, e1)
    u, v = (tv * p).sum() / det, (d * q).sum() / det
    return [round(float(x), 6) for x in (u, v, 1 - u - v,
                                         (e2 * q).sum() / det)]


def trace_lane(scene, cam, width, height, pix, sample, max_bounces, seed):
    """The eager route and the fused per-sample route's plain version on
    one lane, bounce by bounce, on the host."""
    o, d, base = camera_rays(cam, width, height, torch.tensor([pix]), sample,
                             seed)
    tb = fused_tables(scene, origin_bound(o))
    # the fused route's ids are Morton-permuted: back to the scene's
    sperm = morton_perm(scene)
    tperm = (tri_morton_perm(scene.tris) if scene.tris is not None
             else None)
    st = init_state(o, d, base)
    alive = torch.tensor([True])
    for b in range(max_bounces):
        p = probe(scene, o, d, alive=alive)
        fo, fd = st[0:3, 0].clone(), st[3:6, 0].clone()
        if tb.tri is not None:
            st, idx = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, b,
                                            n_sph=tb.n_sph,
                                            use_sky=tb.use_sky)
        else:
            st, idx = bounce_fwd_plain(st, tb.table, b, use_sky=tb.use_sky,
                                       sph=tb.sph)
        k = int(idx[0])
        fused = (-1 if k < 0 else int(sperm[k]) if k < scene.n_pad
                 else scene.n_pad + int(tperm[k - scene.n_pad]))
        eager = int(p.idx[0]) if bool(p.hit[0]) else -1
        same = torch.equal(fo, o[0]) and torch.equal(fd, d[0])
        line = (f"    bounce {b}: eager winner {eager}, fused winner {fused}"
                f", the same ray bits {same}")
        if eager != fused and scene.tris is not None:
            for j in sorted({eager, fused}):
                if j >= scene.n_pad:
                    t = j - scene.n_pad
                    line += (f"; triangle {t} (u, v, w, t) under the eager "
                             f"ray {_bary(scene.tris, t, o[0], d[0])}, the "
                             f"fused {_bary(scene.tris, t, fo, fd)}")
        print(line, flush=True)
        if eager < 0 and fused < 0:
            break
        rand3 = torch.stack([rng.draw_uniform(base, b, s, -1.0, 1.0)
                             for s in range(3)], dim=-1)
        rr = rng.draw_uniform(base, b, 3, 0.0, 1.0)
        d = torch.where(p.hit[:, None], scatter_direction(
            d, p.normal_raw, p.inside, p.specular, p.ior, rand3, rr), d)
        o = torch.where(p.hit[:, None], p.next_origin, o)
        alive = alive & p.hit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="trimesh")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--max-bounces", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route", choices=sorted(ROUTES), default="regen")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--own-basis", action="store_true")
    args = ap.parse_args(argv)
    w, h, mb = args.width, args.height, args.max_bounces
    scene = make_scene(args.scene, device=args.device)
    cam = default_camera(scene)
    basis = None if args.own_basis else cam.basis()[:3]
    oracle = NativeOracle(scene)
    print(f"{args.scene} {w}x{h} {args.spp} spp, route {args.route} on "
          f"{args.device}, the oracle on "
          f"{'its own' if args.own_basis else 'the route' + chr(39) + 's'} "
          f"camera basis; "
          f"camera bits {cam.position.cpu().numpy().view(np.uint32)}",
          flush=True)
    first = {}
    for s in range(args.spp):
        for m in range(1, mb + 1):
            kw = dict(spp=1, sample_start=s, seed=args.seed, max_bounces=m)
            img, rays = render_pass(scene, cam, width=w, height=h,
                                    **ROUTES[args.route], **kw)
            o, o_rays = oracle.render_pass(cam.position, cam.look_at, w, h,
                                           basis=basis, **kw)
            off = np.abs(img.cpu().numpy() - o).max(axis=-1) > OFF
            for y, x in np.argwhere(off):
                first.setdefault((int(y), int(x), s), m)
            print(f"  sample {s}, max_bounces {m}: rays {rays} / oracle "
                  f"{o_rays}, pixels past {OFF}: {int(off.sum())}",
                  flush=True)
    host = make_scene(args.scene, device="cpu")
    host_cam = Camera(position=cam.position.detach().cpu(),
                      look_at=cam.look_at.detach().cpu())
    for (y, x, s), m in sorted(first.items()):
        print(f"pixel ({y},{x}) sample {s}: its colour parts at "
              f"max_bounces {m} (bounce {m - 1}, counted from 0)",
              flush=True)
        trace_lane(host, host_cam, w, h, y * w + x, s, mb, args.seed)


if __name__ == "__main__":
    main()
