#!/usr/bin/env python
"""Inverse rendering: recover perturbed scene parameters from a target
image. The PyTorch counterpart of the JAX package's
examples/04_inverse_rendering.py.

Render a target with the true scene, perturb materials, then
gradient-descend the perturbed scene back using ``make_train_step``
(``torch.optim.Adam`` over the scene's leaves, fixed RNG streams so the
loss is deterministic). The default backend, "fused", runs each step's
forward through the CUDA bounce kernel (K4) and its backward through K5
and K6. --device cpu runs the plain versions on the CPU.

The CLI wraps a larger version of this as
``python -m tpu_ray_torch.cli fit``.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rgb")
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=54)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from tpu_ray_torch import default_camera, make_scene
    from tpu_ray_torch.grad import make_train_step, render_mean

    true_scene = make_scene(args.scene, device=args.device)
    camera = default_camera(true_scene)
    kw = dict(width=args.width, height=args.height, spp=args.spp,
              backend=args.backend)

    # The target a camera would have photographed.
    target = render_mean(true_scene, camera, **kw)

    # Perturb the albedo of every real sphere by a fixed offset.
    n = true_scene.n_real
    bad_albedo = true_scene.albedo.clone()
    bad_albedo[:n] += 0.25
    start = dataclasses.replace(true_scene,
                                albedo=bad_albedo.clamp(0.0, 1.0))

    # fixed_samples=True: every step renders the same RNG streams as the
    # target, so MSE -> 0 exactly at recovery (the deterministic setting;
    # drop it for fresh-sample stochastic optimization).
    init_fn, step_fn = make_train_step(
        optimizer=lambda params: torch.optim.Adam(list(params.values()),
                                                  lr=args.lr),
        train_camera=False, fixed_samples=True, **kw)
    state = init_fn(start, camera)

    def albedo_error(albedo):
        return float((albedo.detach()[:n] - true_scene.albedo[:n])
                     .abs().mean())

    err0 = albedo_error(start.albedo)
    for i in range(args.steps):
        state, loss = step_fn(state, target)
        if (i + 1) % max(1, args.steps // 5) == 0:
            print(f"step {i + 1:4d}  image MSE {float(loss):.3e}  "
                  f"albedo |err| {albedo_error(state.scene.albedo):.4f}")

    err = albedo_error(state.scene.albedo)
    print(f"mean |albedo error|: {err0:.4f} -> {err:.4f}")
    if state.scene.albedo.is_cuda:
        torch.cuda.synchronize()
    return state, err0, err


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
