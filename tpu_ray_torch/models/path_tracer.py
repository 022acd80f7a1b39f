"""The progressive Monte-Carlo wavefront path tracer and the simpler
estimators (port of ``tpu_ray/models/path_tracer.py``).

The reference's per-pixel recursive loop (RenderTile, main.cpp:348-495) is
a batched wavefront: every ray of a sample advances through the bounce
loop together, with an alive mask instead of ``break``. rays_cast is the
reference's counter: +1 per bounce-loop iteration entered per pixel sample
(main.cpp:390).

Backends: "torch" searches with the plain ``ops/intersect.nearest_hit``
(and ``ops/intersect_tri.nearest_hit_tri`` for a scene's triangles),
"cuda" with the K1 kernel (and K7 for triangles), both through ``probe``
(the JAX ``probe_jnp``/``probe_pallas``: the two hits merged into one
primitive id space); "fused" with regen runs the K2 persistent-wavefront
kernel (spheres and triangles), and without it the per-sample fused route
(one sample at a time through the K4 bounce kernel, its sphere search
culled in the kernel by the Morton sphere tiles, or K8 on a triangle
scene, ``kernels/bounce_step.make_fused_sample``).

``shading`` picks the estimator: "path" (the reference algorithm), or the
"flat" and "lambert_shadow" estimators of ``ops/shading_modes``, which
"torch" and "cuda" run eagerly per sample and "fused" runs through the K9
kernel (``kernels/simple_shade.make_simple_trace``, all spp samples in
one launch; it ignores regen and max_bounces, as the JAX package does).

Triangle scenes take these routes within the JAX package's residency
rule (``kernels/bounce_step.resident_tables_fit``: trimesh and small
``obj:`` meshes). Past it (bigmesh, large ``obj:`` meshes) the triangle
search of every backend is the listed search of
``kernels/tri_intersect.tri_nearest_hit_stream`` (K10 on the card), fed by
the alive lanes; ``trace_rays`` then re-sorts its wavefront at every
bounce by (alive, direction octant), so a block's rays share a direction
octant and its tile list stays short; and "fused" (with or without regen,
and its estimators, which warn) falls back to the probe route of backend
"cuda", as the JAX package falls back to its probe route.

``render_pixels``/``render_pass`` are differentiable w.r.t. the scene and
camera tensors: "torch" and "cuda" through autograd of the eager loop
(the search carries no history; the payload recompute carries the
gradient), "fused" through ``kernels/regen.RegenTrace`` (K2 recording
forward, K3 backward), ``bounce_step.FusedSample`` (K4 or K8 forward, K5
replay and K6 backward) without regen, or ``simple_shade.SimpleTrace``
(K9 forward; its backward re-runs the eager estimator on K1/K7).
On the eager routes remat=True recomputes each sample in the backward,
and remat="save_hits" recomputes it from the hits its forward recorded
(``HitTape``), so the backward runs no search; remat="save_hits_bounce"
does too, and recomputes each bounce of the sample on its own from its
own stretch of the tape, so the backward holds one bounce's intermediates
at a time.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_ray_torch.config import SHADINGS, RenderConfig
from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, default_camera
from tpu_ray_torch.core.scene import F32_MAX, Scene, make_scene
from tpu_ray_torch.kernels.bounce_step import (fused_tables,
                                               make_fused_sample,
                                               origin_bound,
                                               resident_tables_fit,
                                               tri_tile_boxes)
from tpu_ray_torch.kernels.regen import make_regen_trace
from tpu_ray_torch.kernels.simple_shade import (make_simple_trace,
                                                pass_tables)
from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit,
                                                  tri_nearest_hit_stream)
from tpu_ray_torch.ops.accumulate import AccumState, accumulate
from tpu_ray_torch.ops.intersect import (Hit, Payload, hit_payload,
                                         nearest_hit, payload_tables)
from tpu_ray_torch.ops.intersect_tri import (merge_payloads, nearest_hit_tri,
                                             tri_payload, tri_payload_tables,
                                             tri_search_table)
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.ops.shade import scatter_direction, sky_color
from tpu_ray_torch.ops.shading_modes import (scene_light_indices,
                                             trace_flat, trace_lambert_shadow)
from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
from tpu_ray_torch.utils.metrics import span, to_host

# search(center, radius, origins, directions) -> Hit
SearchFn = Callable[..., Hit]
# tri_search(tri_search_table, origins, directions) -> Hit
# probe(scene, origins, directions, alive=None) -> Payload
ProbeFn = Callable[..., Payload]

_SEARCH = {"torch": nearest_hit, "cuda": sphere_nearest_hit}
_TRI_SEARCH = {"torch": nearest_hit_tri, "cuda": tri_nearest_hit}
_MAX = float(F32_MAX)


def past_residency(scene: Scene) -> bool:
    """Is scene a triangle scene past ``resident_tables_fit`` (bigmesh)?
    Its triangle search is then the listed one of every backend."""
    return scene.tris is not None and not resident_tables_fit(
        scene.n_pad, scene.tris.n_pad)


class HitTape:
    """The outcome of every search of one sample, for remat="save_hits"
    and "save_hits_bounce" (the JAX ``_name_hit`` policy). The sample's
    first run records, in call order, each search's hit mask and winner
    (the winner as i16 below 2^15 primitives, else i32: 3 or 5 B a ray); a
    rerun after ``rewind`` or ``seek`` (a checkpoint's recompute in the
    backward) replays them instead of searching. t is not kept: its one
    consumer is the miss test, so a replayed hit has t = 0 and a replayed
    miss F32_MAX."""

    def __init__(self):
        self.saved = []
        self.next: Optional[int] = None   # None: record

    def rewind(self):
        """Replay from the first search if a run was recorded."""
        self.next = 0 if self.saved else None

    def mark(self) -> int:
        """The position of the next search: a rerun of what follows
        replays from there (``seek``)."""
        return len(self.saved) if self.next is None else self.next

    def seek(self, pos: int):
        """Replay from ``pos`` (a ``mark``) if that search was recorded; a
        recording run goes on recording."""
        if pos < len(self.saved):
            self.next = pos

    def search(self, n_prim: int, fn, *args) -> Hit:
        if self.next is None:
            hit = fn(*args)
            wide = torch.int16 if n_prim < 2 ** 15 else torch.int32
            self.saved.append((hit.t < _MAX, hit.idx.to(wide)))
            return hit
        mask, idx = self.saved[self.next]
        self.next += 1
        return Hit(t=torch.where(mask, 0.0, _MAX),
                   idx=idx.to(torch.int32))


def _search(tape: Optional[HitTape], n_prim: int, fn, *args) -> Hit:
    return fn(*args) if tape is None else tape.search(n_prim, fn, *args)


def tile_order(width: int, height: int, tile: int = 32):
    """Flat pixel indices in 32x32-tile-major order, and the inverse.
    Neighbouring lanes stay spatially coherent, so the lanes of a warp
    follow similar paths in the regen kernel. Built once a size (a
    1920x1080 frame has 2,040 tiles); each call gets its own copies."""
    perm, inv = _tile_order(width, height, tile)
    return perm.copy(), inv.copy()


@functools.lru_cache(maxsize=8)
def _tile_order(width: int, height: int, tile: int):
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    order = [idx[ty:ty + tile, tx:tx + tile].reshape(-1)
             for ty in range(0, height, tile)
             for tx in range(0, width, tile)]
    perm = np.concatenate(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def tile_pixels(width: int, height: int, device, tile: int = 32):
    """``tile_order``'s perm as an int64 tensor built on ``device`` by
    views and copies of an arange: no host table is made or sent. Built
    each call, not kept: a table kept on the device would add its bytes
    to a fwd+bwd step's peak, which falls in the backward after the
    untile's backward has released the step's table."""
    idx = torch.arange(width * height, dtype=torch.int64,
                       device=device).view(height, width)
    fh, fw = height - height % tile, width - width % tile
    bands = []
    # the whole bands of tile rows, then the ragged last band; in each
    # band its whole tiles, row-major within each, then its ragged tile
    for b in (idx[:fh].view(fh // tile, tile, width),
              idx[fh:].view(1, height - fh, width)):
        nb, th, _ = b.shape
        whole = b[:, :, :fw].reshape(nb, th, fw // tile, tile)
        bands.append(torch.cat(
            [whole.permute(0, 2, 1, 3).reshape(nb, th * fw),
             b[:, :, fw:].reshape(nb, th * (width - fw))], 1))
    return torch.cat([b.reshape(-1) for b in bands])


class _Untile(torch.autograd.Function):
    """out[perm[i]] = color_sum[i], the inverse tile order's gather as a
    scatter by perm; its backward is the gather by perm, with no
    ``inv`` and no sorted accumulate (perm is a permutation)."""

    @staticmethod
    def forward(ctx, color_sum, perm):
        ctx.save_for_backward(perm)
        return torch.empty_like(color_sum).index_copy_(0, perm, color_sum)

    @staticmethod
    def backward(ctx, grad):
        perm, = ctx.saved_tensors
        return grad[perm], None


def untile_image(color_sum, width: int, height: int, perm):
    """Tile-major [n,3] colour buffer -> [H,W,3] image. perm: the tile
    order as a tensor on color_sum's device (``tile_pixels``)."""
    with span("untile"):
        return _Untile.apply(color_sum, perm).reshape(height, width, 3)


def probe(scene: Scene, origins, directions, search: SearchFn = nearest_hit,
          tables=None, tri_search=nearest_hit_tri, tri_tab=None,
          tri_tables=None, alive=None, boxes=None,
          tape: Optional[HitTape] = None) -> Payload:
    """The nearest hit of each ray and its differentiable payload (JAX
    ``probe_jnp``/``probe_pallas``): the sphere search, ``hit_payload``,
    then for a triangle scene tri_search over tri_tab (the triangles'
    ``tri_search_table``), ``tri_payload`` and ``merge_payloads`` (a
    sphere wins a tie in t). Past the residency rule the triangle search
    is ``tri_nearest_hit_stream`` over the tile boxes (``tri_tile_boxes``)
    whatever tri_search is, and only the alive lanes [R] bool (None: all)
    feed its lists; a dead lane's payload is then a miss's. tape: records
    or replays each search (remat="save_hits", "save_hits_bounce").
    tables/tri_tab/tri_tables/boxes: the scene's, built here when None."""
    with span("sphere_search"):
        hit = _search(tape, scene.n_pad, search, scene.center, scene.radius,
                      origins, directions)
    with span("payload"):
        p = hit_payload(scene, origins, directions, hit, tables)
    if scene.tris is None:
        return p
    if tri_tab is None:
        tri_tab = tri_search_table(scene.tris)
    m = scene.tris.n_pad
    with span("tri_search"):
        if past_residency(scene):
            if boxes is None:
                boxes = tri_tile_boxes(scene.tris)
            th = _search(tape, m, tri_nearest_hit_stream, tri_tab, boxes,
                         origins, directions, alive)
        else:
            th = _search(tape, m, tri_search, tri_tab, origins, directions)
    with span("payload"):
        tp = tri_payload(scene.tris, origins, directions, th, tri_tables)
        return merge_payloads(p, tp, scene.n_pad)


def probe_for(scene: Scene, backend: str) -> ProbeFn:
    """``probe`` with backend's searches ("torch" or "cuda") and the
    scene's tables built once, for every probe of a pass: (scene,
    origins, directions, alive=None, tape=None) -> Payload."""
    search, tri_search = _SEARCH[backend], _TRI_SEARCH[backend]
    with span("probe_tables"):
        tables = payload_tables(scene)
        tri_tab = tri_tables = boxes = None
        if scene.tris is not None:
            tri_tab = tri_search_table(scene.tris)
            tri_tables = tri_payload_tables(scene.tris)
            if past_residency(scene):
                boxes = tri_tile_boxes(scene.tris)
    return lambda sc, o, d, alive=None, tape=None: probe(
        sc, o, d, search, tables, tri_search, tri_tab, tri_tables, alive,
        boxes, tape)


def trace_rays(scene: Scene, origins, directions, stream_base,
               max_bounces: int, probe_fn: ProbeFn = probe,
               sort_rays: Optional[bool] = None,
               tape: Optional[HitTape] = None):
    """Trace a flat ray wavefront to completion (reference main.cpp:388-482
    with alive-masking) -> (color [R,3] linear radiance, rays_cast [R]).
    probe_fn(scene, origins, directions, alive=) -> Payload (``probe``,
    ``probe_for``).

    sort_rays (default: on exactly past the residency rule, where the
    triangle search is the listed one): at the top of every bounce the
    wavefront is permuted by a stable argsort of (alive, direction
    octant), dead lanes last, so each block's rays share an octant and its
    list of reachable tiles stays short, and all-dead blocks list nothing.
    Every per-lane value rides the permutation (origin, direction,
    attenuation, colour, alive, rays, RNG base, slot) and the output is
    unsorted at the end, so each lane computes what it computes unsorted.

    tape (remat="save_hits_bounce", with a probe_fn that searches through
    the same tape): each bounce runs under its own
    ``torch.utils.checkpoint``, so the backward recomputes one bounce at a
    time; the bounce's recompute seeks the tape to the bounce's own first
    search (``HitTape.mark`` at the bounce's first run) and replays it."""
    if sort_rays is None:
        sort_rays = past_residency(scene)
    n = origins.shape[0]
    dev = origins.device

    def bounce(b, pos, origin, direction, atten, color, alive, rays_cast,
               base, slot):
        if tape is not None:
            tape.seek(pos)
        if sort_rays:
            with span("ray_sort"):
                octant = ((direction[:, 0] > 0.0).to(torch.int64) * 4
                          + (direction[:, 1] > 0.0).to(torch.int64) * 2
                          + (direction[:, 2] > 0.0).to(torch.int64))
                order = torch.argsort(torch.where(alive, octant, 8),
                                      stable=True)
                origin, direction, atten, color = (
                    origin[order], direction[order], atten[order],
                    color[order])
                alive, rays_cast, base, slot = (
                    alive[order], rays_cast[order], base[order], slot[order])
        rays_cast = rays_cast + alive
        p = probe_fn(scene, origin, direction, alive=alive)
        with span("shade"):
            # miss: optional sky emission, then the ray dies
            # (main.cpp:433-440)
            if scene.use_sky:
                sky_mask = (alive & ~p.hit)[..., None]
                color = color + torch.where(
                    sky_mask, sky_color(direction) * atten, 0.0)
            live_hit = alive & p.hit
            lh = live_hit[..., None]
            color = color + torch.where(lh, p.emissive * atten, 0.0)
            atten = torch.where(lh, atten * p.albedo, atten)

            rand3 = torch.stack([rng.draw_uniform(base, b, s, -1.0, 1.0)
                                 for s in range(3)], dim=-1)
            rand_reflect = rng.draw_uniform(base, b, 3, 0.0, 1.0)
            new_dir = scatter_direction(direction, p.normal_raw, p.inside,
                                        p.specular, p.ior, rand3,
                                        rand_reflect)
            direction = torch.where(lh, new_dir, direction)
            origin = torch.where(lh, p.next_origin, origin)
        return (origin, direction, atten, color, live_hit, rays_cast, base,
                slot)

    state = (origins, directions,
             torch.ones((n, 3), dtype=torch.float32, device=dev),
             torch.zeros((n, 3), dtype=torch.float32, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.zeros(n, dtype=torch.int64, device=dev), stream_base,
             torch.arange(n, device=dev))
    for b in range(max_bounces):
        if not to_host(state[4].any(), bool):
            break   # later bounces change nothing
        if tape is None:
            state = bounce(b, None, *state)
        else:
            state = checkpoint(bounce, b, tape.mark(), *state,
                               use_reentrant=False)
    color, rays_cast, slot = state[3], state[5], state[7]
    if sort_rays:
        with span("ray_sort"):
            inv = torch.empty_like(slot)
            inv[slot] = torch.arange(n, device=dev)
            color, rays_cast = color[inv], rays_cast[inv]
    return color, rays_cast


REMATS = (False, True, "save_hits", "save_hits_bounce")


def render_pixels(scene: Scene, camera: Camera, pixel, *, width: int,
                  height: int, spp: int, sample_start: int, seed: int = 0,
                  max_bounces: int = 5, backend: str = "torch",
                  ray_chunk: Optional[int] = None, shading: str = "path",
                  lights: tuple = (), regen: bool = False,
                  remat: Union[bool, str] = False,
                  probe_fn: Optional[ProbeFn] = None, light_data=None):
    """``spp`` jittered samples for a flat pixel subset [R] ->
    (color_sum [R,3] summed over spp, rays_cast int). Differentiable.

    shading "flat"/"lambert_shadow" (lights: the global indices of the
    light spheres, ``ops/shading_modes.scene_light_indices``; light_data:
    their ``scene_light_data``, gathered from ``scene`` when None) run the
    estimator of ``ops/shading_modes``; on "fused" through K9, which
    ignores max_bounces and regen. remat=True (backends
    "torch"/"cuda") recomputes each sample in the backward instead of
    keeping its activations (``torch.utils.checkpoint``); remat=
    "save_hits" does too, but its forward records each search's hit mask
    and winner (``HitTape``) and the recompute replays them, so the
    backward searches nothing; remat="save_hits_bounce" is "save_hits"
    with each bounce of the path estimator checkpointed again on its own
    (``trace_rays(tape=)``), as the JAX package's per-bounce policy: the
    backward holds one bounce's intermediates at a time. "fused" ignores
    remat, since its backward keeps only the winner records or, for the
    estimators, nothing. probe_fn (backends "torch"/"cuda"): the probe of
    every search, in place of ``probe_for(scene, backend)`` (the
    sphere-sharded probe of ``parallel.render``).

    Past the residency rule "fused" (with or without regen, and its
    estimators, which warn) falls back to the probe route of backend
    "cuda" (K1 and K10 on the card), as the JAX package falls back to its
    probe route: K2/K3's i16 records overflow past 2^15 primitives and
    the resident kernels hold the whole table."""
    if shading not in SHADINGS:
        raise ValueError(f"shading must be one of {SHADINGS}, got "
                         f"{shading!r}")
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    if backend == "fused" and past_residency(scene):
        if shading != "path":
            warnings.warn(
                f"the fused {shading} estimator needs resident tables; "
                f"{scene.tris.n_pad} padded triangles are past "
                "resident_tables_fit, so it falls back to the probe route "
                "and the streaming triangle search (slower)", stacklevel=2)
        backend, regen = "cuda", False
    n = pixel.shape[0]
    chunk = n if ray_chunk is None else ray_chunk
    if n % chunk:
        raise ValueError("ray_chunk must divide the pixel count")
    fused_trace, extra = None, ()
    if backend == "fused" and shading != "path":
        fused_trace = make_simple_trace(width, height, seed, spp, shading,
                                        tuple(lights))
        # K9's tables, built once for every chunk of the pass, and kept
        # for the next pass while nothing writes to the scene or camera
        extra = (pass_tables(scene, camera, tuple(lights)),)
    elif backend == "fused" and regen:
        # each slab runs its own wavefront to its own slowest lane (and,
        # under autograd, records and reverses its own trace)
        fused_trace = make_regen_trace(width, height, seed, max_bounces, spp)
    if fused_trace is not None:
        parts = [fused_trace(scene, camera, pixel[k:k + chunk], sample_start,
                             *extra)
                 for k in range(0, n, chunk)]
        return (torch.cat([c for c, _ in parts]),
                sum(r for _, r in parts))

    color_sum = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
    if backend == "fused":
        sample = make_fused_sample(width, height, seed, max_bounces)
        tb = fused_tables(scene, origin_bound(camera.position[None]))
        rays = torch.zeros((), dtype=torch.int64, device=pixel.device)
        for s in range(sample_start, sample_start + spp):
            parts = [sample(scene, camera, pixel[k:k + chunk], s, tb)
                     for k in range(0, n, chunk)]
            color_sum = color_sum + torch.cat([c for c, _ in parts])
            rays = rays + sum(rc.sum() for _, rc in parts)
        return color_sum, int(rays)

    if probe_fn is None:
        probe_fn = probe_for(scene, backend)
    per_bounce = remat == "save_hits_bounce" and shading == "path"
    if shading == "path":
        def trace(o, d, base, pf, tape):
            return trace_rays(scene, o, d, base, max_bounces, pf,
                              tape=tape if per_bounce else None)
    elif shading == "flat":
        def trace(o, d, base, pf, tape):
            return trace_flat(scene, o, d, pf)
    else:
        def trace(o, d, base, pf, tape):
            return trace_lambert_shadow(scene, o, d, pf, lights, light_data)

    def one_sample(s, tape=None):
        pf = probe_fn
        if tape is not None:     # remat="save_hits*": record, or replay
            tape.rewind()
            pf = functools.partial(probe_fn, tape=tape)
        o, d, base = camera_rays(camera, width, height, pixel, s, seed)
        colors, rays = [], 0
        for k in range(0, n, chunk):
            c, rc = trace(o[k:k + chunk], d[k:k + chunk], base[k:k + chunk],
                          pf, tape)
            colors.append(c)
            rays += to_host(rc.sum(), int)
        return torch.cat(colors), rays

    rays = 0
    for s in range(sample_start, sample_start + spp):
        if remat in ("save_hits", "save_hits_bounce") and \
                torch.is_grad_enabled():
            c, rc = checkpoint(one_sample, s, HitTape(),
                               use_reentrant=False)
        elif remat and torch.is_grad_enabled():
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
                lights: tuple = (), regen: bool = False,
                cull_secondary: bool = False):
    """One progressive pass: ``spp`` jittered samples for every pixel ->
    (image_sum [H,W,3] linear radiance summed over spp, rays_cast int).
    ``shading`` picks the estimator: "path", "flat" or "lambert_shadow"
    (with ``lights``, see ``ops/shading_modes.scene_light_indices``).
    Runs on the scene's device. cull_secondary is accepted for the JAX
    package's signature (its octant mask for bounces 1..) and changes
    nothing: K4 culls every bounce's sphere search by the Morton sphere
    tiles, bit-identically."""
    del cull_secondary
    dev = scene.device
    fused = backend == "fused"
    if fused:
        with span("tile_order"):
            pixel = tile_pixels(width, height, dev)
    else:
        pixel = torch.arange(width * height, dtype=torch.int64, device=dev)
    color_sum, rays = render_pixels(
        scene, camera, pixel, width=width, height=height, spp=spp,
        sample_start=sample_start, seed=seed, max_bounces=max_bounces,
        backend=backend, ray_chunk=ray_chunk, shading=shading,
        lights=lights, regen=regen)
    if fused:
        return untile_image(color_sum, width, height, pixel), rays
    return color_sum.reshape(height, width, 3), rays


class PathTracer:
    """Progressive path tracer bound to a RenderConfig and a device: each
    ``step`` folds one spp-sample pass into the accumulator."""

    def __init__(self, config: RenderConfig, scene: Scene | None = None,
                 device="cuda"):
        self.config = config
        self.scene = (scene if scene is not None
                      else make_scene(config.scene, device=device))
        self.camera = default_camera(self.scene)
        self.lights: tuple = ()
        if config.shading == "lambert_shadow":
            self.lights = scene_light_indices(self.scene)

    def init_state(self) -> AccumState:
        return AccumState.zeros(self.config.height, self.config.width,
                                device=self.scene.device)

    def step(self, state: AccumState, camera: Camera | None = None):
        """One progressive pass -> (new AccumState, rays_cast int)."""
        cfg = self.config
        with span("pass"):
            img_sum, rays = render_pass(
                self.scene, camera or self.camera, width=cfg.width,
                height=cfg.height, spp=cfg.spp, sample_start=state.samples,
                seed=cfg.seed, max_bounces=cfg.max_bounces,
                backend=cfg.backend, ray_chunk=cfg.ray_chunk,
                shading=cfg.shading, lights=self.lights, regen=cfg.regen)
            with span("accumulate"):
                state = accumulate(state, img_sum, cfg.spp)
        return state, rays

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
