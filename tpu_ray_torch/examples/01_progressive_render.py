#!/usr/bin/env python
"""Progressive rendering with PathTracer: the library form of the
reference's browser loop (reference wasm/wasm.cpp:176-222: one progressive
pass per animation frame, accumulated into a running mean). The PyTorch
counterpart of the JAX package's examples/01_progressive_render.py.

Each ``tracer.step(state)`` renders ``spp`` fresh jittered samples per
pixel and folds them into the accumulator; image quality improves
monotonically with passes and any pass is a valid (noisier) image, so a
render can stop, resume, or checkpoint at every pass boundary (see
tpu_ray_torch/utils/checkpoint.py).

The default backend, "fused", runs every bounce of a sample through the
hand-written CUDA bounce kernel (K4, its sphere search culled by Morton
sphere tiles); "cuda" runs the CUDA search kernels inside the PyTorch
bounce loop, and "torch" the plain PyTorch versions. --device cpu runs
the plain versions of every kernel on the CPU.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rtweekend",
                    help="rgb | randomized | rtweekend | trimesh | ...")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--spp", type=int, default=4, help="samples per pass")
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"],
                    help="fused = the CUDA bounce kernels")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="render.png")
    args = ap.parse_args(argv)

    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.utils.png import write_png

    cfg = RenderConfig(scene=args.scene, width=args.width,
                       height=args.height, spp=args.spp,
                       backend=args.backend)
    tracer = PathTracer(cfg, device=args.device)

    state = tracer.init_state()
    total_rays = 0
    for i in range(args.passes):
        state, rays = tracer.step(state)
        total_rays += int(rays)
        print(f"pass {i + 1}/{args.passes}: {int(state.samples)} spp "
              f"accumulated, {total_rays:,} rays cast")

    write_png(args.out, tracer.srgb_image(state).cpu().numpy())
    print(f"wrote {args.out}")
    return state


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
