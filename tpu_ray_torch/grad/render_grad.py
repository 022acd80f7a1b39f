"""Differentiable render entry point (port of
``tpu_ray/grad/render_grad.py``, single device).

``render_mean`` is the differentiable analogue of
``models/path_tracer.render_pass``: the same ops, returning the spp-mean
radiance image. Call ``.backward()`` on a loss of it to fill the ``.grad``
of every scene and camera tensor that requires grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.core.scene import Scene
from tpu_ray_torch.models.path_tracer import (render_pixels, tile_order,
                                              untile_image)


def render_mean(scene: Scene, camera: Camera, *, width: int, height: int,
                spp: int, sample_start: int = 0, seed: int = 0,
                max_bounces: int = 5, backend: str = "torch",
                ray_chunk: Optional[int] = None, remat: bool = False,
                cull_secondary: bool = False, exact_argmin: bool = False,
                regen: bool = False, return_rays: bool = False):
    """Differentiable spp-mean radiance image [H,W,3] on the scene's
    device.

    backend "torch"/"cuda": autograd of the eager bounce loop; remat=True
    recomputes each sample in the backward (``torch.utils.checkpoint``)
    instead of keeping its activations. "fused" (pixels in 32x32-tile
    order, so the lanes of a warp stay coherent in both sweeps) ignores
    remat: with regen=True the persistent-wavefront trace with its K2
    recording forward and K3 backward; without, the per-sample route (K4
    forward, K5 replay, K6 backward), its later bounces culled by the
    octant mask when cull_secondary. exact_argmin changes nothing (the
    port's search is always exact). return_rays=True also returns the
    rays-cast count (an int, no gradient)."""
    del exact_argmin
    dev = scene.device
    fused = backend == "fused"
    if fused:
        perm, inv = tile_order(width, height)
        pixel = torch.as_tensor(perm, device=dev)
    else:
        pixel = torch.arange(width * height, dtype=torch.int64, device=dev)
    color_sum, rays = render_pixels(
        scene, camera, pixel, width=width, height=height, spp=spp,
        sample_start=sample_start, seed=seed, max_bounces=max_bounces,
        backend=backend, ray_chunk=ray_chunk, regen=regen, remat=remat,
        cull_secondary=cull_secondary)
    if fused:
        img = untile_image(color_sum, width, height, inv)
    else:
        img = color_sum.reshape(height, width, 3)
    img = img / torch.tensor(float(spp), dtype=torch.float32, device=dev)
    if return_rays:
        return img, rays
    return img


def image_mse(image, target):
    """Mean-squared error over all pixels and channels (the default
    loss)."""
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=image.device)
    return torch.mean((image - target) ** 2)
