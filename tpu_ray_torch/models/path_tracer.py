"""The progressive Monte-Carlo wavefront path tracer (port of
``tpu_ray/models/path_tracer.py``, path estimator).

The reference's per-pixel recursive loop (RenderTile, main.cpp:348-495) is
a batched wavefront: every ray of a sample advances through the bounce
loop together, with an alive mask instead of ``break``. rays_cast is the
reference's counter: +1 per bounce-loop iteration entered per pixel sample
(main.cpp:390).

Backends: "torch" searches with the plain ``ops/intersect.nearest_hit``
(and ``ops/intersect_tri.nearest_hit_tri`` for a scene's triangles),
"cuda" with the K1 kernel (and K7 for triangles) inside the same bounce
loop, the two hits merged into one primitive id space as the JAX probe
route's ``_with_triangles`` does; "fused" with regen runs the K2
persistent-wavefront kernel (spheres and triangles), and without it the
per-sample fused route (one sample at a time through the K4 bounce kernel,
``kernels/bounce_step.make_fused_sample``; sphere scenes only).

Triangle scenes take these routes only within the JAX package's residency
rule (``kernels/bounce_step.resident_tables_fit``: trimesh and small
``obj:`` meshes); past it (bigmesh) every route refuses, as does the
per-sample route on any triangle scene (ROADMAP.md queue B).

``render_pixels``/``render_pass`` are differentiable w.r.t. the scene and
camera tensors: "torch" and "cuda" through autograd of the eager bounce
loop (the search carries no history; the payload recompute carries the
gradient), "fused" through ``kernels/regen.RegenTrace`` (K2 recording
forward, K3 backward) or, without regen, ``bounce_step.FusedSample``
(K4 forward, K5 replay and K6 backward).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_ray_torch.config import RenderConfig
from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, default_camera
from tpu_ray_torch.core.scene import Scene, make_scene
from tpu_ray_torch.kernels.bounce_step import (fused_tables,
                                               make_fused_sample,
                                               resident_tables_fit)
from tpu_ray_torch.kernels.regen import make_regen_trace
from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
from tpu_ray_torch.kernels.tri_intersect import tri_nearest_hit
from tpu_ray_torch.ops.accumulate import AccumState, accumulate
from tpu_ray_torch.ops.intersect import (Hit, hit_payload, nearest_hit,
                                         payload_tables)
from tpu_ray_torch.ops.intersect_tri import (merge_payloads, nearest_hit_tri,
                                             tri_payload, tri_payload_tables,
                                             tri_search_table)
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.ops.shade import scatter_direction, sky_color
from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8

# search(center, radius, origins, directions) -> Hit
SearchFn = Callable[..., Hit]
# tri_search(tri_search_table, origins, directions) -> Hit

_SEARCH = {"torch": nearest_hit, "cuda": sphere_nearest_hit}
_TRI_SEARCH = {"torch": nearest_hit_tri, "cuda": tri_nearest_hit}


def _check_route(shading: str) -> None:
    if shading != "path":
        raise NotImplementedError(
            f"shading={shading!r}: the flat and Lambert estimators are not "
            "ported yet (ROADMAP.md queue A, item 4)")


def _check_tris(scene: Scene, backend: str, regen: bool) -> None:
    """Refuse the triangle routes that are not ported (none falls back)."""
    if scene.tris is None:
        return
    if not resident_tables_fit(scene.n_pad, scene.tris.n_pad):
        raise NotImplementedError(
            f"{scene.tris.n_pad} padded triangles are past "
            "resident_tables_fit: the streaming triangle search "
            "(nearest_hit_tri_stream, kernel #11) and the sorted-bounce "
            "wavefront are not ported yet (ROADMAP.md queue B)")
    if backend == "fused" and not regen:
        raise NotImplementedError(
            "backend 'fused' without regen on a triangle scene: "
            "bounce_fwd_list (kernel #7) and the triangle modes of K4-K6 "
            "are not ported yet (ROADMAP.md queue B); use the regen route")


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
               tables=None, tri_search=nearest_hit_tri, tri_tab=None,
               tri_tables=None):
    """Trace a flat ray wavefront to completion (reference main.cpp:388-482
    with alive-masking) -> (color [R,3] linear radiance, rays_cast [R]).
    A scene's triangles are searched by tri_search over tri_tab (their
    ``tri_search_table``) and their payload merged with the spheres' (a
    sphere wins a tie in t)."""
    if tables is None:
        tables = payload_tables(scene)
    if scene.tris is not None:
        if tri_tab is None:
            tri_tab = tri_search_table(scene.tris)
        if tri_tables is None:
            tri_tables = tri_payload_tables(scene.tris)
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
        if tri_tab is not None:
            tp = tri_payload(scene.tris, origin, direction,
                             tri_search(tri_tab, origin, direction),
                             tri_tables)
            p = merge_payloads(p, tp, scene.n_pad)
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
                  regen: bool = False, remat: bool = False,
                  cull_secondary: bool = False):
    """``spp`` jittered samples for a flat pixel subset [R] ->
    (color_sum [R,3] summed over spp, rays_cast int). Differentiable.

    remat=True (backends "torch"/"cuda") recomputes each sample's trace in
    the backward instead of keeping its activations
    (``torch.utils.checkpoint``); "fused" ignores it, since its backward
    keeps only the winner records. cull_secondary (fused without regen)
    culls bounces 1.. by the octant mask, bit-identically."""
    _check_route(shading)
    _check_tris(scene, backend, regen)
    n = pixel.shape[0]
    chunk = n if ray_chunk is None else ray_chunk
    if n % chunk:
        raise ValueError("ray_chunk must divide the pixel count")
    if backend == "fused" and regen:
        # each slab runs its own wavefront to its own slowest lane (and,
        # under autograd, records and reverses its own trace)
        trace = make_regen_trace(width, height, seed, max_bounces, spp)
        parts = [trace(scene, camera, pixel[k:k + chunk], sample_start)
                 for k in range(0, n, chunk)]
        return (torch.cat([c for c, _ in parts]),
                sum(r for _, r in parts))

    color_sum = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
    if backend == "fused":
        sample = make_fused_sample(width, height, seed, max_bounces,
                                   cull_secondary=cull_secondary)
        tb = fused_tables(scene)
        rays = torch.zeros((), dtype=torch.int64, device=pixel.device)
        for s in range(sample_start, sample_start + spp):
            parts = [sample(scene, camera, pixel[k:k + chunk], s, tb)
                     for k in range(0, n, chunk)]
            color_sum = color_sum + torch.cat([c for c, _ in parts])
            rays = rays + sum(rc.sum() for _, rc in parts)
        return color_sum, int(rays)

    search, tri_search = _SEARCH[backend], _TRI_SEARCH[backend]
    tables = payload_tables(scene)
    tri_tab, tri_tables = None, None
    if scene.tris is not None:
        tri_tab = tri_search_table(scene.tris)
        tri_tables = tri_payload_tables(scene.tris)

    def one_sample(s):
        o, d, base = camera_rays(camera, width, height, pixel, s, seed)
        colors, rays = [], 0
        for k in range(0, n, chunk):
            c, rc = trace_rays(scene, o[k:k + chunk], d[k:k + chunk],
                               base[k:k + chunk], max_bounces, search,
                               tables, tri_search, tri_tab, tri_tables)
            colors.append(c)
            rays += int(rc.sum())
        return torch.cat(colors), rays

    rays = 0
    for s in range(sample_start, sample_start + spp):
        if remat and torch.is_grad_enabled():
            c, rc = checkpoint(one_sample, s, use_reentrant=False)
        else:
            c, rc = one_sample(s)
        color_sum = color_sum + c
        rays += rc
    return color_sum, rays


def render_pass(scene: Scene, camera: Camera, *, width: int, height: int,
                spp: int, sample_start: int = 0, seed: int = 0,
                max_bounces: int = 5, backend: str = "torch",
                ray_chunk: Optional[int] = None, shading: str = "path",
                regen: bool = False, cull_secondary: bool = False):
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
        backend=backend, ray_chunk=ray_chunk, shading=shading, regen=regen,
        cull_secondary=cull_secondary)
    if fused:
        return untile_image(color_sum, width, height, inv), rays
    return color_sum.reshape(height, width, 3), rays


class PathTracer:
    """Progressive path tracer bound to a RenderConfig and a device: each
    ``step`` folds one spp-sample pass into the accumulator."""

    def __init__(self, config: RenderConfig, scene: Scene | None = None,
                 device="cuda"):
        _check_route(config.shading)
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
            ray_chunk=cfg.ray_chunk, shading=cfg.shading, regen=cfg.regen,
            cull_secondary=cfg.cull_secondary)
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
