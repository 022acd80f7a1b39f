#!/usr/bin/env python
"""Building your own scene with SceneBuilder. The PyTorch counterpart of
the JAX package's examples/02_custom_scene.py.

SceneBuilder is the reference's CreateScalarSphere + AoS->SoA packing
pipeline (reference main.cpp:57-91) as one host-side object: add spheres
in world units, then ``build`` pads to a multiple of 128 slots (radius-0
padding spheres are never hit) and packs the SoA Scene, a dataclass of
torch tensors on one device; make its tensors trainable
(``core.scene.trainable_scene``) to differentiate through it.

Materials, matching the reference's shading model (main.cpp:446-481):
  albedo            diffuse color (attenuation per bounce)
  specular in [0,1] mirror-ness: 0 = Lambertian, 1 = perfect mirror
  emissive          light emission (added when a ray hits)
  ior != 0          dielectric (glass): refract/reflect with Schlick

--backend fused (the default) renders through the CUDA bounce kernel
(K4); torch and cuda through the PyTorch bounce loop, with plain or CUDA
searches. --device cpu runs the plain versions on the CPU.
"""
import argparse
import math
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="custom_scene.png")
    args = ap.parse_args(argv)

    from tpu_ray_torch import SceneBuilder, orbit_camera
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.utils.png import write_png

    b = SceneBuilder()
    # ground: one huge sphere (the reference's trick for a ground plane)
    b.add(center=(0, -1000, 0), radius=1000, albedo=(0.5, 0.5, 0.5))
    # a matte red ball, a mirror, a glass ball, and a white light
    b.add((-2.5, 1, 0), 1.0, albedo=(0.9, 0.2, 0.2))
    b.add((0.0, 1, 0), 1.0, albedo=(0.9, 0.9, 0.9), specular=1.0)
    b.add((2.5, 1, 0), 1.0, albedo=(1.0, 1.0, 1.0), ior=1.5)
    b.add((0.0, 4.5, 1.5), 1.0, albedo=(1, 1, 1), emissive=(6, 6, 6))

    scene = b.build(
        look_at=(0.0, 1.0 / 16.0, 0.0),  # world units * WORLD_SCALE (1/16)
        use_sky=True,                    # sky gradient on miss
        default_distance=9.0 / 16.0,     # orbit camera defaults
        default_x_angle=math.pi / 2.0,
        default_y_height=2.0 / 16.0,
        device=args.device,
    )
    camera = orbit_camera(scene.look_at.cpu().numpy(),
                          scene.default_distance, scene.default_x_angle,
                          scene.default_y_height, device=args.device)

    image_sum, rays = render_pass(
        scene, camera, width=args.width, height=args.height, spp=args.spp,
        sample_start=0, max_bounces=5, backend=args.backend)
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
