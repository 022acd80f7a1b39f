"""Differentiable render entry points (port of
``tpu_ray/grad/render_grad.py``): one process, and sharded.

``render_mean`` is the differentiable analogue of
``models/path_tracer.render_pass``: the same ops, returning the spp-mean
radiance image. Call ``.backward()`` on a loss of it to fill the ``.grad``
of every scene and camera tensor that requires grad.
``render_mean_sharded`` runs the same image over a ``parallel`` mesh, SPMD
over its ranks, and gives every rank's leaves the gradient one process
gets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_ray_torch.core.camera import CAMERA_LEAVES, Camera
from tpu_ray_torch.core.scene import SCENE_LEAVES, Scene
from tpu_ray_torch.core.trimesh import TRI_LEAVES
from tpu_ray_torch.models.path_tracer import (render_pixels, tile_pixels,
                                              untile_image)
from tpu_ray_torch.parallel.render import _GatherRays, _image, _plan
from tpu_ray_torch.utils.metrics import span, to_device


def render_mean(scene: Scene, camera: Camera, *, width: int, height: int,
                spp: int, sample_start: int = 0, seed: int = 0,
                max_bounces: int = 5, backend: str = "torch",
                ray_chunk: Optional[int] = None,
                remat: Union[bool, str] = False,
                cull_secondary: bool = False, exact_argmin: bool = False,
                regen: bool = False, return_rays: bool = False):
    """Differentiable spp-mean radiance image [H,W,3] on the scene's
    device.

    backend "torch"/"cuda": autograd of the eager bounce loop; remat=True
    recomputes each sample in the backward (``torch.utils.checkpoint``)
    instead of keeping its activations, remat="save_hits" recomputes
    it from the hit masks and winners its forward recorded, so the
    backward runs no search, and remat="save_hits_bounce" does that one
    bounce at a time (each bounce checkpointed on its own, replaying its
    own hits), so the backward holds one bounce's intermediates.
    "fused" (pixels in 32x32-tile
    order, so the lanes of a warp stay coherent in both sweeps) ignores
    remat: with regen=True the persistent-wavefront trace with its K2
    recording forward and K3 backward; without, the per-sample route (K4
    forward, K5 replay, K6 backward), every bounce's sphere search culled
    in K4 by the Morton sphere tiles. Past the residency rule (bigmesh)
    "fused" falls back to the eager route of backend "cuda", which takes
    remat (``models/path_tracer.render_pixels``). exact_argmin and
    cull_secondary are accepted for the JAX package's signature and change
    nothing (the port's search is always exact, and always culled).
    return_rays=True also returns the rays-cast count (an int, no
    gradient)."""
    del exact_argmin, cull_secondary
    with span("render_mean"):
        dev = scene.device
        fused = backend == "fused"
        if fused:
            with span("tile_order"):
                pixel = tile_pixels(width, height, dev)
        else:
            pixel = torch.arange(width * height, dtype=torch.int64,
                                 device=dev)
        color_sum, rays = render_pixels(
            scene, camera, pixel, width=width, height=height, spp=spp,
            sample_start=sample_start, seed=seed, max_bounces=max_bounces,
            backend=backend, ray_chunk=ray_chunk, regen=regen, remat=remat)
        if fused:
            img = untile_image(color_sum, width, height, pixel)
        else:
            img = color_sum.reshape(height, width, 3)
        img = img / to_device(float(spp), dev, torch.float32)
    if return_rays:
        return img, rays
    return img


class _SumGradOverWorld(torch.autograd.Function):
    """Identity on the scene's and camera's leaves whose backward sums
    their gradients over every rank, in one all-reduce (one collective,
    so ranks whose graphs differ cannot issue them in different orders;
    a leaf with no gradient on a rank adds zeros)."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i, n in enumerate(ctx.needs_input_grad) if n]
        gs = [grads[i] if grads[i] is not None
              else torch.zeros(ctx.like[i][0], dtype=ctx.like[i][1],
                               device=ctx.like[i][2]) for i in need]
        out = [None] * len(grads)
        if not gs:
            return tuple(out)
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat)
        for i, part in zip(need, flat.split([g.numel() for g in gs])):
            out[i] = part.view(ctx.like[i][0])
        return tuple(out)


def _world_summed(scene: Scene, camera: Camera):
    """The scene and camera with every leaf passed through
    ``_SumGradOverWorld`` (one node for all of them)."""
    names = scene.leaves
    outs = _SumGradOverWorld.apply(*[scene.leaf(k) for k in names],
                                   *[getattr(camera, k)
                                     for k in CAMERA_LEAVES])
    got = dict(zip(names + CAMERA_LEAVES, outs))
    tris = scene.tris
    if tris is not None:
        tris = dataclasses.replace(tris, **{
            k: got[f"tris.{k}"] for k in TRI_LEAVES})
    scene = dataclasses.replace(scene, tris=tris,
                                **{k: got[k] for k in SCENE_LEAVES})
    return scene, Camera(**{k: got[k] for k in CAMERA_LEAVES})


def render_mean_sharded(scene: Scene, camera: Camera, *, mesh: DeviceMesh,
                        width: int, height: int, spp: int,
                        sample_start: int = 0, seed: int = 0,
                        max_bounces: int = 5, backend: str = "torch",
                        ray_chunk: Optional[int] = None,
                        remat: Union[bool, str] = False,
                        cull_secondary: bool = False,
                        exact_argmin: bool = False, regen: bool = False):
    """Differentiable spp-mean image [H,W,3], the pixel axis split over
    ``mesh`` (``parallel.make_mesh``); every rank calls it with the whole
    scene and camera and gets the whole image.

    A loss of it must be computed alike on every rank (as ``image_mse``
    against one target is). Its backward then gives every rank's leaves
    the gradient one process gets: each rank's colour rows take their
    share of the image's gradient (divided over the "spheres" dim, whose
    shards trace the same rays: the JAX package's pmean), the sharded
    probe's all-gather sums each shard's payload gradient over the
    shards, and the leaves' gradients are summed over every rank in one
    all-reduce (a sphere shard's slice adds only its own rows). The
    routes and remat are ``render_mean``'s; a "spheres" dim takes backends
    "torch" and "cuda"."""
    del exact_argmin, cull_secondary
    scene, camera = _world_summed(scene, camera)
    local, probe, pixel, order = _plan(scene, mesh, width, height, backend)
    color_sum, _ = render_pixels(
        local, camera, pixel, width=width, height=height, spp=spp,
        sample_start=sample_start, seed=seed, max_bounces=max_bounces,
        backend=backend, ray_chunk=ray_chunk, regen=regen, remat=remat,
        probe_fn=probe)
    img = _image(_GatherRays.apply(color_sum, mesh), width, height, order)
    return img / torch.tensor(float(spp), dtype=torch.float32,
                              device=img.device)


def image_mse(image, target):
    """Mean-squared error over all pixels and channels (the default
    loss)."""
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=image.device)
    return torch.mean((image - target) ** 2)
