#!/usr/bin/env python
"""Triangle meshes alongside spheres (Möller-Trumbore intersection). The
PyTorch counterpart of the JAX package's examples/06_triangle_mesh.py.

A capability extension over the reference (spheres only):
``pack_triangles`` turns an indexed mesh into a padded Triangles soup
stored as (v0, e1, e2) edge form. Attach it to any Scene; every backend
searches spheres and triangles in one global primitive id space, and
gradients flow to the triangle vertices too. On the default backend,
"fused", each bounce runs the CUDA listed-triangle bounce kernel (K8:
each 256-ray block lists the 128-triangle tiles its rays can reach and
folds them front to back); --backend cuda runs the CUDA sphere and
triangle searches (K1, K7) inside the PyTorch bounce loop. --device cpu
runs the plain versions on the CPU.

This renders a glass icosphere mesh + back-wall quad next to a diffuse
sphere.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--subdivisions", type=int, default=2,
                    help="icosphere detail: 2 -> 320 tris, 3 -> 1280")
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="trimesh.png")
    args = ap.parse_args(argv)

    import dataclasses
    import math

    import numpy as np

    from tpu_ray_torch import SceneBuilder, default_camera, pack_triangles
    from tpu_ray_torch.core.trimesh import icosphere, merge, quad
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.utils.png import write_png

    # Spheres: ground + one matte ball.
    b = SceneBuilder()
    b.add((0, -1000, 0), 1000, albedo=(0.45, 0.45, 0.5))
    b.add((-2.2, 1.0, 0.0), 1.0, albedo=(0.8, 0.3, 0.2))
    scene = b.build(look_at=(0.0, 1.0 / 16.0, 0.0), use_sky=True,
                    default_distance=8.0 / 16.0,
                    default_x_angle=math.pi / 2.0,
                    default_y_height=2.5 / 16.0, device=args.device)

    # Mesh: unit icosphere scaled/translated next to it + a back-wall quad,
    # in the same 1/16 world scale the builder applied to the spheres.
    s = 1.0 / 16.0
    v1, f1 = icosphere(args.subdivisions)
    v1 = v1 * (1.0 * s) + np.float32([1.8 * s, 1.0 * s, 0.0])
    v2, f2 = quad((-6 * s, 0.0, -3 * s), (6 * s, 0.0, -3 * s),
                  (6 * s, 5 * s, -3 * s), (-6 * s, 5 * s, -3 * s))
    verts, faces, albedo = merge([(v1, f1, (1.0, 1.0, 1.0)),
                                  (v2, f2, (0.3, 0.6, 0.3))])
    # per-face material arrays: the icosphere faces (first len(f1)) are glass
    ior = np.zeros(len(faces), np.float32)
    ior[:len(f1)] = 1.5
    tris = pack_triangles(verts, faces, albedo=albedo, ior=ior,
                          device=args.device)
    scene = dataclasses.replace(scene, tris=tris)
    print(f"{tris.n_real} triangles (padded to {tris.n_pad}) "
          f"+ {scene.n_real} spheres")

    camera = default_camera(scene)
    image_sum, rays = render_pass(
        scene, camera, width=args.width, height=args.height, spp=args.spp,
        sample_start=0, backend=args.backend)
    image = image_sum / args.spp
    write_png(args.out,
              pack_rgba8(linear_to_srgb(image)).flip(0).cpu().numpy())
    print(f"{int(rays):,} rays cast -> {args.out}")
    return image


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
