"""The progressive Monte-Carlo wavefront path tracer (port of
``tpu_ray/models/path_tracer.py``, path estimator).

The reference's per-pixel recursive loop (RenderTile, main.cpp:348-495) is
a batched wavefront: every ray of a sample advances through the bounce
loop together, with an alive mask instead of ``break``. rays_cast is the
reference's counter: +1 per bounce-loop iteration entered per pixel sample
(main.cpp:390).

Backends: "torch" searches with the plain ``ops/intersect.nearest_hit``,
"cuda" with the K1 kernel inside the same bounce loop, and "fused" with
regen runs the K2 persistent-wavefront kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from tpu_ray_torch.config import RenderConfig
from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, default_camera
from tpu_ray_torch.core.scene import Scene, make_scene
from tpu_ray_torch.kernels.regen import trace_regen
from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
from tpu_ray_torch.ops.accumulate import AccumState, accumulate
from tpu_ray_torch.ops.intersect import (Hit, hit_payload, nearest_hit,
                                         payload_tables)
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.ops.shade import scatter_direction, sky_color
from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8

# search(center, radius, origins, directions) -> Hit
SearchFn = Callable[..., Hit]

_SEARCH = {"torch": nearest_hit, "cuda": sphere_nearest_hit}


def _check_route(backend: str, shading: str, regen: bool) -> None:
    if shading != "path":
        raise NotImplementedError(
            f"shading={shading!r}: the flat and Lambert estimators are not "
            "ported yet (ROADMAP.md queue A, item 5)")
    if backend == "fused" and not regen:
        raise NotImplementedError(
            "backend='fused' without regen (the per-sample bounce_fwd "
            "route) is not ported yet (ROADMAP.md queue A, item 6)")


def tile_order(width: int, height: int, tile: int = 32):
    """Flat pixel indices in 32x32-tile-major order, and the inverse.
    Neighbouring lanes stay spatially coherent, so the lanes of a warp
    follow similar paths in the regen kernel."""
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    order = [idx[ty:ty + tile, tx:tx + tile].reshape(-1)
             for ty in range(0, height, tile)
             for tx in range(0, width, tile)]
    perm = np.concatenate(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def untile_image(color_sum, width: int, height: int, inv):
    """Tile-major [n,3] colour buffer -> [H,W,3] image."""
    inv = torch.as_tensor(inv, device=color_sum.device)
    return color_sum[inv].reshape(height, width, 3)


def trace_rays(scene: Scene, origins, directions, stream_base,
               max_bounces: int, search: SearchFn = nearest_hit,
               tables=None):
    """Trace a flat ray wavefront to completion (reference main.cpp:388-482
    with alive-masking) -> (color [R,3] linear radiance, rays_cast [R])."""
    if tables is None:
        tables = payload_tables(scene)
    n = origins.shape[0]
    dev = origins.device
    origin, direction = origins, directions
    atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
    color = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rays_cast = torch.zeros(n, dtype=torch.int64, device=dev)
    for b in range(max_bounces):
        if not bool(alive.any()):
            break   # later bounces change nothing
        rays_cast += alive
        p = hit_payload(scene, origin, direction,
                        search(scene.center, scene.radius, origin,
                               direction), tables)
        # miss: optional sky emission, then the ray dies (main.cpp:433-440)
        if scene.use_sky:
            sky_mask = (alive & ~p.hit)[..., None]
            color = color + torch.where(sky_mask, sky_color(direction) * atten,
                                        0.0)
        live_hit = alive & p.hit
        lh = live_hit[..., None]
        color = color + torch.where(lh, p.emissive * atten, 0.0)
        atten = torch.where(lh, atten * p.albedo, atten)

        rand3 = torch.stack([rng.draw_uniform(stream_base, b, s, -1.0, 1.0)
                             for s in range(3)], dim=-1)
        rand_reflect = rng.draw_uniform(stream_base, b, 3, 0.0, 1.0)
        new_dir = scatter_direction(direction, p.normal_raw, p.inside,
                                    p.specular, p.ior, rand3, rand_reflect)
        direction = torch.where(lh, new_dir, direction)
        origin = torch.where(lh, p.next_origin, origin)
        alive = live_hit
    return color, rays_cast


def render_pixels(scene: Scene, camera: Camera, pixel, *, width: int,
                  height: int, spp: int, sample_start: int, seed: int = 0,
                  max_bounces: int = 5, backend: str = "torch",
                  ray_chunk: Optional[int] = None, shading: str = "path",
                  regen: bool = False):
    """``spp`` jittered samples for a flat pixel subset [R] ->
    (color_sum [R,3] summed over spp, rays_cast int)."""
    _check_route(backend, shading, regen)
    n = pixel.shape[0]
    chunk = n if ray_chunk is None else ray_chunk
    if n % chunk:
        raise ValueError("ray_chunk must divide the pixel count")
    if backend == "fused":
        # each slab runs its own wavefront to its own slowest lane
        parts = [trace_regen(scene, camera, pixel[k:k + chunk], width=width,
                             height=height, spp=spp, seed=seed,
                             max_bounces=max_bounces,
                             sample_start=sample_start)
                 for k in range(0, n, chunk)]
        return (torch.cat([c for c, _ in parts]),
                sum(r for _, r in parts))

    search = _SEARCH[backend]
    tables = payload_tables(scene)
    color_sum = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
    rays = 0
    for s in range(sample_start, sample_start + spp):
        o, d, base = camera_rays(camera, width, height, pixel, s, seed)
        colors = []
        for k in range(0, n, chunk):
            c, rc = trace_rays(scene, o[k:k + chunk], d[k:k + chunk],
                               base[k:k + chunk], max_bounces, search,
                               tables)
            colors.append(c)
            rays += int(rc.sum())
        color_sum = color_sum + torch.cat(colors)
    return color_sum, rays


def render_pass(scene: Scene, camera: Camera, *, width: int, height: int,
                spp: int, sample_start: int = 0, seed: int = 0,
                max_bounces: int = 5, backend: str = "torch",
                ray_chunk: Optional[int] = None, shading: str = "path",
                regen: bool = False):
    """One progressive pass: ``spp`` jittered samples for every pixel ->
    (image_sum [H,W,3] linear radiance summed over spp, rays_cast int).
    Runs on the scene's device."""
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
        backend=backend, ray_chunk=ray_chunk, shading=shading, regen=regen)
    if fused:
        return untile_image(color_sum, width, height, inv), rays
    return color_sum.reshape(height, width, 3), rays


class PathTracer:
    """Progressive path tracer bound to a RenderConfig and a device: each
    ``step`` folds one spp-sample pass into the accumulator."""

    def __init__(self, config: RenderConfig, scene: Scene | None = None,
                 device="cuda"):
        _check_route(config.backend, config.shading, config.regen)
        self.config = config
        self.scene = (scene if scene is not None
                      else make_scene(config.scene, device=device))
        self.camera = default_camera(self.scene)

    def init_state(self) -> AccumState:
        return AccumState.zeros(self.config.height, self.config.width,
                                device=self.scene.device)

    def step(self, state: AccumState, camera: Camera | None = None):
        """One progressive pass -> (new AccumState, rays_cast int)."""
        cfg = self.config
        img_sum, rays = render_pass(
            self.scene, camera or self.camera, width=cfg.width,
            height=cfg.height, spp=cfg.spp, sample_start=state.samples,
            seed=cfg.seed, max_bounces=cfg.max_bounces, backend=cfg.backend,
            ray_chunk=cfg.ray_chunk, shading=cfg.shading, regen=cfg.regen)
        return accumulate(state, img_sum, cfg.spp), rays

    def srgb_image(self, state: AccumState):
        """u8 RGBA frame [H,W,4], rows flipped so row 0 is the image top."""
        srgb = linear_to_srgb(state.mean, exact=self.config.exact_srgb)
        return torch.flip(pack_rgba8(srgb), dims=[0])

    def render(self, passes: int = 1, camera: Camera | None = None):
        """Host progressive loop -> (AccumState, total rays cast)."""
        state = self.init_state()
        total_rays = 0
        for _ in range(passes):
            state, rays = self.step(state, camera)
            total_rays += rays
        return state, total_rays
