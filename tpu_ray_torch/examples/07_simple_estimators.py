#!/usr/bin/env python
"""The non-path estimators: flat shading and Lambert + shadow rays. The
PyTorch counterpart of the JAX package's examples/07_simple_estimators.py.

BASELINE configs 1-2 use these simpler estimators instead of the full
path tracer (tpu_ray_torch/ops/shading_modes.py): ``flat`` shades primary
visibility only (albedo + emissive of the first hit, or sky),
``lambert_shadow`` adds one nearest-hit shadow probe per emissive sphere:
the standard direct-lighting estimator built from the same probe
machinery the path tracer uses (the reference itself has only the path
estimator; these generalize its emissive/sky terms, main.cpp:433-440).

On the fused backend (the default) these run the CUDA estimator kernel
(K9, tpu_ray_torch/csrc/simple_shade.cu): raygen, search, winner gather,
shading and the shadow probes of every sample in one launch. torch and
cuda run the estimator in PyTorch over the plain or CUDA searches.
--device cpu runs the plain versions on the CPU.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sixteen")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--shading", default="lambert_shadow",
                    choices=["flat", "lambert_shadow"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="estimator.png")
    args = ap.parse_args(argv)

    from tpu_ray_torch import default_camera, make_scene
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.ops.shading_modes import scene_light_indices
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.utils.png import write_png

    scene = make_scene(args.scene, device=args.device)
    camera = default_camera(scene)
    lights = (scene_light_indices(scene)
              if args.shading == "lambert_shadow" else ())
    image_sum, rays = render_pass(
        scene, camera, width=args.width, height=args.height, spp=args.spp,
        sample_start=0, backend=args.backend, shading=args.shading,
        lights=lights)
    img = pack_rgba8(linear_to_srgb(image_sum / args.spp))
    write_png(args.out, img.cpu().numpy())
    print(f"wrote {args.out} ({args.shading}, {int(rays)} rays, "
          f"{len(lights)} lights)")
    return int(rays)


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
