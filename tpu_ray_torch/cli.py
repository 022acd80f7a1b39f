"""Command-line interface of the port, with the flags of ``tpu_ray/cli.py``
for what is ported.

Subcommands:
  render  progressive render -> PNG
  fit     inverse rendering: optimize scene/camera to match a target image
  scenes  list built-in scenes

Run on the card (the default) or with ``--device cpu``, e.g.
  python -m tpu_ray_torch.cli render --scene rtweekend --width 1920 \\
      --height 1080 --spp 64 --backend fused --regen --out /tmp/x.png
  python -m tpu_ray_torch.cli fit --scene rtweekend --width 512 \\
      --height 512 --spp 4 --backend fused --steps 200 --out /tmp/fit.png
  python -m tpu_ray_torch.cli render --backend fused --no-regen \\
      --cull-secondary --out /tmp/y.png

--exact-argmin is accepted and changes nothing: the port's search is
always exact. Not ported yet (ROADMAP.md queue A): --checkpoint/--resume,
render's --metrics, --profile, --mesh and the animate and bench
subcommands.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _add_common(ap: argparse.ArgumentParser):
    ap.add_argument("--scene", default="rtweekend",
                    help="rgb | randomized | rtweekend (reference scenes "
                         "0-2) | single | sixteen | sixtyfour | trimesh "
                         "(spheres + triangles) | obj:PATH (a Wavefront "
                         "OBJ mesh on a ground quad)")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--spp", type=int, default=1,
                    help="samples per pixel per pass")
    ap.add_argument("--max-bounces", type=int, default=5)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "cuda", "fused"],
                    help="torch = plain PyTorch search; cuda = the CUDA "
                         "sphere-search kernel; fused = the CUDA regen "
                         "kernel (with --regen) or the per-sample CUDA "
                         "bounce kernels (--no-regen)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ray-chunk", type=int, default=None)
    ap.add_argument("--shading", default="path",
                    choices=["path", "flat", "lambert_shadow"])
    ap.add_argument("--exact-argmin", action="store_true",
                    help="accepted for the JAX command lines; the port's "
                         "search is always exact")
    ap.add_argument("--cull-secondary", action="store_true",
                    help="fused backend without regen: octant-split tile "
                         "culling on bounces 1.. (bit-identical)")
    ap.add_argument("--regen", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fused backend: persistent-wavefront sample "
                         "regeneration (default ON with --backend fused; "
                         "--no-regen runs the per-sample route)")
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
                       cull_secondary=args.cull_secondary,
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


def cmd_fit(args) -> int:
    """Inverse rendering: recover per-sphere materials (and, with
    --perturb-geom, geometry; with --fit-camera, the camera position) from
    a rendered target image. As ``tpu_ray/cli.py`` cmd_fit, whose
    docstring gives the measured reasons for its choices: the target uses
    the training spp and RNG streams (the loss is 0 at the truth), every
    real sphere is perturbed independently, only the perturbed groups are
    optimized, each group with its own learning rate and an Adam eps of 1%
    of the group's initial gradient RMS. A frozen group is not handed to
    the optimizer. Prints the loss and the parameter recovery."""
    import numpy as np
    import torch
    from tpu_ray_torch.core.camera import Camera, default_camera
    from tpu_ray_torch.core.scene import make_scene, trainable_scene
    from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.utils.metrics import MetricsLogger, StepTimer
    from tpu_ray_torch.utils.png import write_png

    if args.mesh is not None:
        raise NotImplementedError(
            "--mesh: sharding is not ported yet (ROADMAP.md queue A, "
            "item 5)")
    scene = make_scene(args.scene, device=args.device)
    camera = default_camera(scene)
    kw = dict(width=args.width, height=args.height, spp=args.spp,
              seed=args.seed, max_bounces=args.max_bounces,
              backend=args.backend, ray_chunk=args.ray_chunk,
              cull_secondary=args.cull_secondary,
              regen=_want_regen(args.regen, args.backend))
    with torch.no_grad():
        target = render_mean(scene, camera, sample_start=0, **{
            **kw, "spp": args.target_spp or args.spp})

    # per-sphere perturbations, masked so radius-0 padding stays inert
    rng = np.random.default_rng(args.seed)
    n = scene.n_pad
    radius = scene.radius.cpu().numpy()
    real = radius > 0.0
    r_scale = float(np.mean(radius[real])) if real.any() else 1.0
    p = args.perturb_geom
    jit_c = rng.normal(0.0, p * 0.05 * r_scale, (n, 3)).astype(np.float32)
    jit_r = rng.uniform(1.0 - p * 0.05, 1.0 + p * 0.05, n).astype(
        np.float32)
    jit_a = rng.uniform(0.6, 1.0, (n, 3)).astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=scene.device)
    perturbed = dataclasses.replace(
        scene,
        center=scene.center + dev(np.where(real[:, None], jit_c, 0.0)
                                  .astype(np.float32)),
        radius=scene.radius * dev(np.where(real, jit_r, 1.0)
                                  .astype(np.float32)),
        albedo=torch.clamp(scene.albedo * dev(jit_a), 0.0, 1.0),
        emissive=scene.emissive * 0.5)
    fit_camera = bool(args.fit_camera)
    cam0 = camera
    if fit_camera:
        cam0 = Camera(position=camera.position + 0.05 * r_scale,
                      look_at=camera.look_at)

    def recovery(s, cam=None):
        def err(a, b):
            return float(np.abs((a - b).detach().cpu().numpy())[real].mean())
        out = dict(d_center=err(s.center, scene.center),
                   d_radius=err(s.radius, scene.radius),
                   d_albedo=err(s.albedo, scene.albedo))
        if fit_camera and cam is not None:
            out["d_camera"] = float((cam.position - camera.position).detach().abs()
                                    .mean())
        return out

    # the initial gradient of every group, for its Adam eps. As the JAX
    # fit's _group: a triangle soup's albedo and emissive join the sphere
    # groups of the same name; its geometry, specular and ior stay frozen
    group_of = {"center": "geom", "radius": "geom", "albedo": "alb",
                "emissive": "emi", "tris.albedo": "alb",
                "tris.emissive": "emi", "position": "cam"}
    s0 = trainable_scene(perturbed)
    c0 = Camera(position=cam0.position.detach().clone().requires_grad_(),
                look_at=cam0.look_at)
    image_mse(render_mean(s0, c0, sample_start=0, **kw), target).backward()
    grads = {k: s0.leaf(k).grad for k in s0.leaves if k in group_of}
    grads["position"] = c0.position.grad

    def eps(group):
        gs = [g for k, g in grads.items() if group_of[k] == group]
        tot = sum(float(torch.sum(g.double() ** 2)) for g in gs)
        cnt = sum(g.numel() for g in gs)
        return max(1e-2 * (tot / max(cnt, 1)) ** 0.5, 1e-12)

    lr_geom = args.lr * r_scale if args.perturb_geom > 0 else 0.0
    has_emissive = bool((scene.emissive.cpu().numpy()[real] > 0.0).any())

    def group_leaves(group):
        return [k for k in scene.leaves if group_of.get(k) == group]
    groups = {"alb": (args.lr, group_leaves("alb"))}
    if lr_geom > 0:
        groups["geom"] = (lr_geom, ["center", "radius"])
    if fit_camera:
        # the nudge is 0.05*r_scale: a fifth of that per step closes it
        # in ~10 steps instead of oscillating across it
        groups["cam"] = (0.01 * r_scale, ["position"])
    if has_emissive:
        groups["emi"] = (args.lr, group_leaves("emi"))

    def optimizer(params):
        return torch.optim.Adam([
            dict(params=[params[k] for k in names], lr=lr, eps=eps(g))
            for g, (lr, names) in groups.items()])

    # remat=True as the JAX fit passes it (eager backends only)
    init_fn, step_fn = make_train_step(
        optimizer=optimizer, train_camera=fit_camera, fixed_samples=True,
        remat=True, **kw)
    state = init_fn(perturbed, cam0)

    log = MetricsLogger(path=args.metrics)
    before = recovery(perturbed, cam0)
    log.log(fit_step=-1, **before)
    loss = float("nan")
    for i in range(args.steps):
        (state, loss), secs = StepTimer.timed(step_fn, state, target)
        log.log(fit_step=i, loss=float(loss), seconds=round(secs, 4))
    after = recovery(state.scene, state.camera)
    log.log(fit_step=args.steps, **after)
    log.close()
    with torch.no_grad():
        img = render_mean(state.scene, state.camera, sample_start=0, **kw)
    write_png(args.out, torch.flip(pack_rgba8(linear_to_srgb(img)),
                                   dims=[0]).cpu().numpy())
    print(f"wrote {args.out} (final loss {float(loss):.6f})",
          file=sys.stderr)
    for k in before:
        print(f"  {k}: {before[k]:.6f} -> {after[k]:.6f}", file=sys.stderr)
    return 0


def cmd_scenes(args) -> int:
    from tpu_ray_torch.core.scene import SCENE_BUILDERS, make_scene
    for i, name in enumerate(SCENE_BUILDERS):
        s = make_scene(name, device="cpu")
        tri = f", {s.tris.n_real} tris" if s.tris is not None else ""
        print(f"{i}: {name:12s} {s.n_real:4d} spheres "
              f"(padded {s.n_pad}){tri}, sky={s.use_sky}")
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

    f = sub.add_parser("fit", help="inverse-rendering optimization demo")
    _add_common(f)
    f.add_argument("--steps", type=int, default=50)
    f.add_argument("--perturb-geom", type=float, default=0.0,
                   help="geometry perturbation scale (default 0: geometry "
                        "gradients are boundary-dominated; set >0 to "
                        "demonstrate)")
    f.add_argument("--lr", type=float, default=0.05)
    f.add_argument("--target-spp", type=int, default=0,
                   help="target-render spp; 0 (default) = match --spp and "
                        "its RNG streams so the loss is 0 at recovery")
    f.add_argument("--fit-camera", action="store_true",
                   help="also nudge + recover the camera position")
    f.add_argument("--out", default="fit.png")
    f.add_argument("--metrics", default=None, help="JSONL metrics file")
    f.add_argument("--mesh", default=None,
                   help="device mesh (not ported yet: raises)")

    sub.add_parser("scenes", help="list built-in scenes")

    args = ap.parse_args(argv)
    if args.cmd == "render":
        return cmd_render(args)
    if args.cmd == "fit":
        return cmd_fit(args)
    return cmd_scenes(args)


if __name__ == "__main__":
    raise SystemExit(main())
