#!/usr/bin/env python
"""Exact pixel gradients through the renderer. The PyTorch counterpart of
the JAX package's examples/03_pixel_gradients.py.

``render_mean`` is an ordinary differentiable PyTorch function: make the
scene's and the camera's tensors trainable (``trainable_scene``,
``trainable_camera``), and one ``.backward()`` of any scalar loss on its
output fills the gradient of EVERY scene parameter (sphere centers, radii,
albedo, emissive, specular, ior, triangle vertices) and of the camera
pose. Discrete choices (which sphere a ray hits, refract-vs-reflect) are
held fixed by the counter-based RNG, so the Monte-Carlo integrand is
piecewise smooth and autodiff gives the exact gradient of the estimator
(SURVEY.md §7 "Gradients through discreteness").

Estimator semantics worth knowing: with hit selection and
refract-vs-reflect held fixed, the gradient is the TRUE derivative almost
everywhere, which is exactly 0 for parameters whose only effect is moving
discontinuity boundaries. In a sky-less scene (e.g. 'rgb') path radiance
is a product of material constants, so camera/geometry gradients vanish
a.e. even though finite differences (which straddle boundaries) do not;
materials still get exact nonzero gradients. Scenes with a sky gradient
(e.g. 'rtweekend', the default here) have radiance continuous in ray
direction, so camera and geometry gradients flow too.

The default backend, "fused", runs the forward through the CUDA bounce
kernel (K4) and the backward through its replay and hand-written
transpose (K5, K6); "torch" and "cuda" take autograd of the PyTorch
bounce loop. --device cpu runs the plain versions on the CPU.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rtweekend")
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=54)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--backend", default="fused",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from tpu_ray_torch import Camera, default_camera, make_scene
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import render_mean

    scene = trainable_scene(make_scene(args.scene, device=args.device))
    camera = trainable_camera(default_camera(scene))

    # Loss: mean brightness of the rendered image. Its gradient answers
    # "how does each parameter move the picture?": the building block of
    # any inverse-rendering / appearance-optimization objective.
    img = render_mean(scene, camera, width=args.width, height=args.height,
                      spp=args.spp, backend=args.backend)
    img.mean().backward()

    def grad(x):
        return x.grad if x.grad is not None else torch.zeros_like(x)

    # the gradients as a Scene and a Camera of the same shapes
    tris = scene.tris
    if tris is not None:
        tris = dataclasses.replace(tris, **{
            k[5:]: grad(scene.leaf(k)) for k in scene.leaves
            if k.startswith("tris.")})
    d_scene = dataclasses.replace(scene, tris=tris, **{
        k: grad(scene.leaf(k)) for k in scene.leaves
        if not k.startswith("tris.")})
    d_camera = Camera(position=grad(camera.position),
                      look_at=grad(camera.look_at))

    n = scene.n_real
    print(f"scene '{args.scene}': {n} spheres, backend={args.backend}")
    print(f"d brightness / d albedo     (first {min(n, 4)} spheres):")
    for i in range(min(n, 4)):
        print(f"  sphere {i}: {d_scene.albedo[i].tolist()}")
    print(f"d brightness / d radius      : {d_scene.radius[:n].tolist()}")
    print(f"d brightness / d center[1]   : {d_scene.center[1].tolist()}")
    print(f"d brightness / d camera pos  : {d_camera.position.tolist()}")
    print(f"d brightness / d camera look : {d_camera.look_at.tolist()}")
    return d_scene, d_camera


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
