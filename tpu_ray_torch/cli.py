"""Command-line interface of the port, with the flags of ``tpu_ray/cli.py``
for what is ported.

Subcommands:
  render  progressive render -> PNG
  scenes  list built-in scenes

Run on the card (the default) or with ``--device cpu``, e.g.
  python -m tpu_ray_torch.cli render --scene rtweekend --width 1920 \\
      --height 1080 --spp 64 --backend fused --regen --out /tmp/x.png

Not ported yet (ROADMAP.md queue A): --checkpoint/--resume, --metrics,
--profile, --mesh, --exact-argmin (the port's search is always exact),
--cull-secondary and the fit, animate and bench subcommands.
"""
from __future__ import annotations

import argparse
import sys
import time


def _add_common(ap: argparse.ArgumentParser):
    ap.add_argument("--scene", default="rtweekend",
                    help="rgb | randomized | rtweekend (reference scenes "
                         "0-2) | single | sixteen | sixtyfour")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--spp", type=int, default=1,
                    help="samples per pixel per pass")
    ap.add_argument("--max-bounces", type=int, default=5)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "cuda", "fused"],
                    help="torch = plain PyTorch search; cuda = the CUDA "
                         "sphere-search kernel; fused = the CUDA regen "
                         "kernel (with --regen)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ray-chunk", type=int, default=None)
    ap.add_argument("--shading", default="path",
                    choices=["path", "flat", "lambert_shadow"])
    ap.add_argument("--regen", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fused backend: persistent-wavefront sample "
                         "regeneration (default ON with --backend fused)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")


def _want_regen(flag, backend: str) -> bool:
    if backend != "fused":
        return False
    return True if flag is None else bool(flag)


def cmd_render(args) -> int:
    import torch
    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.utils.png import write_png

    cfg = RenderConfig(scene=args.scene, width=args.width, height=args.height,
                       spp=args.spp, max_bounces=args.max_bounces,
                       backend=args.backend, seed=args.seed,
                       ray_chunk=args.ray_chunk, shading=args.shading,
                       regen=_want_regen(args.regen, args.backend))
    tracer = PathTracer(cfg, device=args.device)
    state = tracer.init_state()
    total_rays, total_secs = 0, 0.0
    for _ in range(args.passes):
        t0 = time.perf_counter()
        state, rays = tracer.step(state)
        if state.mean.is_cuda:
            torch.cuda.synchronize(state.mean.device)
        total_secs += time.perf_counter() - t0
        total_rays += rays
    write_png(args.out, tracer.srgb_image(state).cpu().numpy())
    print(f"wrote {args.out} ({state.samples} spp accumulated, "
          f"{total_rays} rays, {total_secs:.3f} s on {args.device})",
          file=sys.stderr)
    return 0


def cmd_scenes(args) -> int:
    from tpu_ray_torch.core.scene import SCENE_BUILDERS, make_scene
    for i, name in enumerate(SCENE_BUILDERS):
        s = make_scene(name, device="cpu")
        print(f"{i}: {name:12s} {s.n_real:4d} spheres "
              f"(padded {s.n_pad}), sky={s.use_sky}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu-ray-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="progressive render -> PNG")
    _add_common(r)
    r.add_argument("--passes", type=int, default=1,
                   help="progressive passes (each adds spp samples)")
    r.add_argument("--out", default="out.png")

    sub.add_parser("scenes", help="list built-in scenes")

    args = ap.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    return cmd_scenes(args)


if __name__ == "__main__":
    raise SystemExit(main())
