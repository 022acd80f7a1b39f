"""K2: the persistent-wavefront regen forward, CUDA kernel ``csrc/regen.cu``.

Replaces ``tpu_ray/kernels/regen.py::regen_step`` (``_regen_kernel`` and,
for steps > 1, ``_regen_multi_kernel``). Each lane owns one pixel for the
whole render and cycles through that pixel's spp samples in place: when
its ray dies (a miss, or the bounce budget spent) it flushes the sample's
colour into a running total and regenerates the next sample's camera ray
in the lane, from the counter RNG. ``regen_steps_plain`` is the same step,
vectorised over the [24, R] state in plain PyTorch; the wrapper
``regen_steps`` takes it for CPU tensors only.

State layout [24, R] f32 (rows 13 and 21 hold u32 bits), as in the JAX
package:
   0-2  origin        3-5  direction     6-8  attenuation
   9-11 colour of the current sample
   12   alive (0/1)   13   rng stream base (u32 bits)
   14   sample index   15   bounce index within the sample
   16-18 colour total over finished samples
   19   pixel x        20   pixel y
   21   h1: per-(pixel, seed) hash (u32 bits); the stream base of sample s
        is pcg_hash(h1 + s * MIX_SAMPLE)
   22   rays-cast counter (exact f32)
   23   unused
cam13 [13] f32: position(3), film_center(3), cam_x(3), cam_y(3), s_end.

The search is exact (the JAX ``exact_argmin=True`` semantics). The JAX
package's Morton permutation of the spheres (``permute_scene``) is a TPU
tile-locality trick and is not ported.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, film_extent
from tpu_ray_torch.core.scene import Scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.ops.intersect import hit_payload, nearest_hit, payload_tables
from tpu_ray_torch.ops.raygen import camera_rays, film_rays
from tpu_ray_torch.ops.shade import scatter_direction, sky_color

__all__ = ["regen_steps", "regen_steps_plain", "wave_init", "cam13",
           "trace_regen"]


def cam13(camera: Camera, s_end: int) -> torch.Tensor:
    """Camera basis + sample end -> [13] f32 (see module docstring)."""
    cam_x, cam_y, _, film_center = camera.basis()
    s = torch.tensor([float(s_end)], dtype=torch.float32,
                     device=camera.position.device)
    return torch.cat([camera.position, film_center, cam_x, cam_y, s])


def wave_init(camera: Camera, pixel, spp: int, seed: int, sample_start: int,
              width: int, height: int):
    """Initial [24, R] state for the pixel set [R]: sample ``sample_start``'s
    primary rays plus the per-lane regeneration constants.
    -> (state, cam13 [13], R)."""
    r = pixel.shape[0]
    o, d, base0 = camera_rays(camera, width, height, pixel, sample_start,
                              seed)
    ax = (pixel % width).to(torch.float32)
    ay = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    h1 = rng.pixel_hash(seed, pixel)
    s0 = float(sample_start)
    s_end = sample_start + spp

    st = torch.zeros((24, r), dtype=torch.float32, device=pixel.device)
    st[0:3] = o.T
    st[3:6] = d.T
    st[6:9] = 1.0
    st[12] = 1.0
    st[13] = rng.u32_to_bits(base0)
    st[14] = s0
    st[19] = ax
    st[20] = ay
    st[21] = rng.u32_to_bits(h1)
    return st, cam13(camera, s_end), r


def _plain_step(st, cam, scene: Scene, tables, *, use_sky: bool,
                max_bounces: int, width: int, height: int):
    """One wavefront step over every lane (``_step_tail`` semantics of the
    JAX package, with the search in front). Returns the new state."""
    o, d = st[0:3].T, st[3:6].T
    atten, color = st[6:9].T, st[9:12].T
    alive = st[12] > 0.5
    base = rng.bits_to_u32(st[13])
    b_i, s_i = st[15], st[14]

    hit = nearest_hit(scene.center, scene.radius, o, d)
    p = hit_payload(scene, o, d, hit, tables)
    live = alive & p.hit
    lh = live[:, None]
    if use_sky:
        sky = (alive & ~p.hit)[:, None]
        color = color + torch.where(sky, sky_color(d) * atten, 0.0)
    color = color + torch.where(lh, p.emissive * atten, 0.0)
    atten = torch.where(lh, atten * p.albedo, atten)

    bounce = b_i.to(torch.int64)
    rand3 = torch.stack([rng.draw_uniform(base, bounce, s, -1.0, 1.0)
                         for s in range(3)], dim=-1)
    rand_reflect = rng.draw_uniform(base, bounce, 3, 0.0, 1.0)
    new_dir = scatter_direction(d, p.normal_raw, p.inside, p.specular,
                                p.ior, rand3, rand_reflect)
    d = torch.where(lh, new_dir, d)
    o = torch.where(lh, p.next_origin, o)

    # the sample ends when its ray dies or its bounce budget is spent
    b_next = b_i + 1.0
    cont = live & (b_next < float(max_bounces))
    finished = alive & ~cont
    s_next = s_i + torch.where(finished, 1.0, 0.0)
    has_more = finished & (s_next < cam[12])
    fin = finished[:, None]
    total = st[16:19].T + torch.where(fin, color, 0.0)
    color = torch.where(fin, 0.0, color)

    # regenerate the next sample's camera ray in the lane
    new_base = rng.sample_base(rng.bits_to_u32(st[21]),
                               s_next.to(torch.int64))
    rd = film_rays(st[19], st[20], new_base, width, height, cam[0:3],
                   cam[3:6], cam[6:9], cam[9:12])
    more = has_more[:, None]
    o = torch.where(more, cam[0:3].expand_as(o), o)
    d = torch.where(more, rd, d)
    atten = torch.where(more, 1.0, atten)
    new_alive = torch.where(finished, has_more.to(torch.float32),
                            live.to(torch.float32))
    base = torch.where(has_more, new_base, base)
    new_b = torch.where(finished, 0.0, b_next)
    rays = st[22] + alive.to(torch.float32)

    return torch.cat([
        o.T, d.T, atten.T, color.T, new_alive[None],
        rng.u32_to_bits(base)[None], s_next[None], new_b[None], total.T,
        st[19:22], rays[None], st[23:24]], dim=0)


def regen_steps_plain(state, cam, scene: Scene, steps: int, *,
                      use_sky: bool, max_bounces: int, width: int,
                      height: int):
    """``steps`` wavefront steps over the [24, R] state, in place. A dead
    lane only advances its bounce row, so once every lane is dead the
    remaining steps are applied to that row at once."""
    tables = payload_tables(scene)
    for k in range(steps):
        if not bool((state[12] > 0.5).any()):
            state[15] += float(steps - k)
            break
        state.copy_(_plain_step(state, cam, scene, tables, use_sky=use_sky,
                                max_bounces=max_bounces, width=width,
                                height=height))
    return state


def regen_steps(state, cam, scene: Scene, steps: int, *, use_sky: bool,
                max_bounces: int, width: int, height: int):
    """K2: ``steps`` persistent-wavefront steps over the [24, R] f32 state,
    updated in place (search + shade + in-lane regeneration). cam: [13]
    f32 (``cam13``). CPU tensors take ``regen_steps_plain``."""
    if not state.is_cuda:
        return regen_steps_plain(state, cam, scene, steps, use_sky=use_sky,
                                 max_bounces=max_bounces, width=width,
                                 height=height)
    dev = state.device
    r, n = state.shape[1], scene.n_pad
    build.require(state, "state", torch.float32, (24, r), dev)
    build.require(cam, "cam13", torch.float32, (13,), dev)
    for name, shape in (("center", (n, 3)), ("radius", (n,)),
                        ("albedo", (n, 3)), ("emissive", (n, 3)),
                        ("specular", (n,)), ("ior", (n,))):
        build.require(getattr(scene, name), name, torch.float32, shape, dev)
    film_w, film_h = film_extent(width, height)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_steps(
            state.data_ptr(), r, cam.data_ptr(), scene.center.data_ptr(),
            scene.radius.data_ptr(), scene.albedo.data_ptr(),
            scene.emissive.data_ptr(), scene.specular.data_ptr(),
            scene.ior.data_ptr(), n, int(steps), int(bool(use_sky)),
            int(max_bounces), int(width), int(height), float(film_w),
            float(film_h), build.stream_of(state))
    build.check("trt_regen_steps", err)
    regen_steps.launches += 1
    return state


regen_steps.launches = 0


def trace_regen(scene: Scene, camera: Camera, pixel, *, width: int,
                height: int, spp: int, seed: int, max_bounces: int,
                sample_start: int = 0):
    """All ``spp`` samples of the pixel set through the persistent
    wavefront -> (color_sum [R,3], rays_cast int). One regen_steps call of
    spp * max_bounces steps: a sample takes at most max_bounces steps, so
    the cap never cuts a lane."""
    st, cam, r = wave_init(camera, pixel, spp, seed, sample_start, width,
                           height)
    regen_steps(st, cam, scene, spp * max_bounces, use_sky=scene.use_sky,
                max_bounces=max_bounces, width=width, height=height)
    return st[16:19].T, int(st[22].to(torch.int64).sum())
