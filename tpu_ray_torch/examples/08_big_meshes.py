#!/usr/bin/env python
"""Big meshes past the residency rule: the listed streaming search. The
PyTorch counterpart of the JAX package's examples/08_big_meshes.py.

Real authored/scanned meshes run 50k-1M triangles, far past anything the
reference can represent (it has no meshes at all). The fused routes hold
their whole search table and record winners in 16 bits, so a triangle
scene past ``resident_tables_fit`` (the JAX package's rule, kept so both
packages route the same scenes) takes the probe route on every backend:
the sphere search (K1 on the card) and the listed triangle search
(K10, tpu_ray_torch/csrc/tri_stream.cu: each 256-ray block lists the
128-triangle tiles its alive rays can reach and folds only those), with
the bounce wavefront re-sorted by (alive, direction octant) at every
bounce so a block's rays share an octant and its list stays short
(``trace_rays(sort_rays=)``). The same route is DIFFERENTIABLE: gradients
flow to every vertex, material, and the camera through the O(R) payload
recompute; ``remat="save_hits"`` replays the winners its forward
recorded, so the backward searches nothing.

This renders an icosphere pair at subdivision 5 (40,962 triangles in
41,088 padded rows, past the rule) and, with --grad, takes one gradient
of an image loss w.r.t. the mesh vertices, the camera pose, and the
sphere materials. The default backend, "cuda", runs K1 and K10; "fused"
falls back to it past the rule. --device cpu runs the plain versions on
the CPU.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--subdivisions", type=int, default=5,
                    help="icosphere detail: 5 -> 40,962 tris (past the "
                         "residency rule), 6 -> 163,842")
    ap.add_argument("--grad", action="store_true",
                    help="also take one gradient step's worth of "
                         "cotangents through the streaming route")
    ap.add_argument("--backend", default="cuda",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="bigmesh.png")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from tpu_ray_torch import default_camera
    from tpu_ray_torch.core.scene import make_trimesh_scene
    from tpu_ray_torch.models.path_tracer import past_residency, render_pass
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.utils.png import write_png

    scene = make_trimesh_scene(subdivisions=args.subdivisions,
                               device=args.device)
    m = scene.tris.n_pad
    streaming = past_residency(scene)
    print(f"{scene.tris.n_real} triangles ({m} padded); route: "
          f"{'listed streaming search' if streaming else 'resident'}")
    cam = default_camera(scene)

    img, rays = render_pass(scene, cam, width=args.width,
                            height=args.height, spp=args.spp,
                            sample_start=0, backend=args.backend)
    write_png(args.out, pack_rgba8(linear_to_srgb(img / args.spp))
              .flip(0).cpu().numpy())
    print(f"wrote {args.out} ({int(rays)} rays cast)")

    if args.grad:
        from tpu_ray_torch.core.camera import trainable_camera
        from tpu_ray_torch.core.scene import trainable_scene
        from tpu_ray_torch.grad import image_mse, render_mean

        target = torch.zeros((args.height, args.width, 3),
                             dtype=torch.float32, device=scene.device)
        ts, tc = trainable_scene(scene), trainable_camera(cam)
        image_mse(render_mean(
            ts, tc, width=args.width, height=args.height, spp=args.spp,
            backend=args.backend, remat="save_hits"), target).backward()

        def grad(x):
            return x.grad if x.grad is not None else torch.zeros_like(x)

        gs = dataclasses.replace(
            ts, tris=dataclasses.replace(ts.tris, **{
                k[5:]: grad(ts.leaf(k)) for k in ts.leaves
                if k.startswith("tris.")}),
            **{k: grad(ts.leaf(k)) for k in ts.leaves
               if not k.startswith("tris.")})
        route = "streaming" if streaming else "resident"
        print(f"|d vertices| = {float(torch.linalg.norm(gs.tris.v0)):.3e}, "
              f"|d camera| = {float(torch.linalg.norm(grad(tc.position))):.3e}"
              f" (gradients through the {route} search)")
        return img, gs
    return img, None


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
