"""The persistent-wavefront regen route: K2 forward (``csrc/regen.cu``),
its recording mode, and K3 backward (``csrc/regen_bwd.cu``).

K2 replaces ``tpu_ray/kernels/regen.py::regen_step`` (``_regen_kernel``
and, for steps > 1, ``_regen_multi_kernel``; with ``with_idx`` it also
records winners). Each lane owns one pixel for the whole render and cycles
through that pixel's spp samples in place: when its ray dies (a miss, or
the bounce budget spent) it flushes the sample's colour into a running
total and regenerates the next sample's camera ray in the lane, from the
counter RNG. ``regen_steps_plain`` is the same step, vectorised over the
[24, R] state in plain PyTorch; the wrappers take it for CPU tensors only.

K2 with a triangle search table also replaces ``regen_step(tri_lists=...)``
(``_regen_list_kernel``, and ``_regen_kernel``'s triangle tiles): after the
spheres every step folds the triangles in id order, so the winner is the
lowest id in the one primitive id space (spheres 0..N-1, triangles
N..N+M-1). The TPU kernel's reachable-tile lists only skip tiles that
cannot hold the nearest hit; the port sweeps every triangle.

K3 replaces ``regen_seg_bwd`` (``_regen_seg_kernel``, with its triangle
branch): the reverse of the whole recorded trace. ``regen_bwd_plain`` is
its plain version.
``make_regen_trace`` wraps the two in a ``torch.autograd.Function``
(the JAX package's custom VJP of the same name).

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
table [P,12] f32: the winner table (``bounce_step.prim_table``: N sphere
rows, then M triangle rows). tri [M,9] f32: the triangle search table
(``ops/intersect_tri.tri_search_table``), None for a sphere scene; the
backward takes only the count n_tri = M.

Records of a recording run (``Records``): the winner id of every step on
live lanes (-1 on a miss) [steps,R] i16, the state at every step
t % seg == 0 [ceil(steps/seg),24,R], and each lane's count of alive steps
t_end [R] i32. A lane that dies stays dead, so entries at t >= t_end are
never written by the kernel and never read.

The search is exact (the JAX ``exact_argmin=True`` semantics). The route
runs on the Morton-permuted scene (``bounce_step.permute_scene``), as the
JAX package's regen entry points do: an exact tie in t goes to the lower
permuted id, the records and d_table are in permuted order, and autograd
carries d_table back through the permutation to the scene's leaves.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, film_extent
from tpu_ray_torch.core.scene import F32_MAX, Scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.bounce_step import (nrm3_bwd, nrm3_fwd,
                                               permute_scene, prim_table,
                                               shade_plain, shade_vjp_plain)
from tpu_ray_torch.ops.intersect import nearest_hit
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri, tri_search_table
from tpu_ray_torch.ops.raygen import camera_rays, film_offsets, film_rays

__all__ = ["regen_steps", "regen_steps_plain", "regen_record",
           "regen_bwd", "regen_bwd_plain", "step_tail_plain", "wave_init",
           "cam13", "trace_regen", "make_regen_trace", "RegenTrace",
           "Records", "SEG_MAX", "regen_tables"]

# the longest segment K3 replays (its per-lane stash is sized for it)
SEG_MAX = 64
# winner records are i16: the primitive id space must stay below 2^15
ID_LIMIT = 2 ** 15


class Records(NamedTuple):
    rec: torch.Tensor    # [steps, R] i16 winner id, -1 on a miss
    chk: torch.Tensor    # [ceil(steps/seg), 24, R] f32 checkpoints
    t_end: torch.Tensor  # [R] i32 alive steps of each lane
    seg: int


def cam13(camera: Camera, s_end: int) -> torch.Tensor:
    """Camera basis + sample end -> [13] f32 (see module docstring)."""
    cam_x, cam_y, _, film_center = camera.basis()
    s = torch.tensor([float(s_end)], dtype=torch.float32,
                     device=camera.position.device)
    return torch.cat([camera.position, film_center, cam_x, cam_y, s])


def _init_state(o, d, base0, pixel, seed: int, sample_start: int,
                width: int):
    """[24, R] state from sample ``sample_start``'s primary rays o, d
    [R,3] and stream bases base0 [R] plus the per-lane constants."""
    st = torch.zeros((24, pixel.shape[0]), dtype=torch.float32,
                     device=pixel.device)
    st[0:3] = o.T
    st[3:6] = d.T
    st[6:9] = 1.0
    st[12] = 1.0
    st[13] = rng.u32_to_bits(base0)
    st[14] = float(sample_start)
    st[19] = (pixel % width).to(torch.float32)
    st[20] = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    st[21] = rng.u32_to_bits(rng.pixel_hash(seed, pixel))
    return st


def wave_init(camera: Camera, pixel, spp: int, seed: int, sample_start: int,
              width: int, height: int):
    """Initial [24, R] state for the pixel set [R]: sample ``sample_start``'s
    primary rays plus the per-lane regeneration constants.
    -> (state, cam13 [13], R)."""
    o, d, base0 = camera_rays(camera, width, height, pixel, sample_start,
                              seed)
    st = _init_state(o, d, base0, pixel, seed, sample_start, width)
    return st, cam13(camera, sample_start + spp), pixel.shape[0]


def _draws(st):
    """The four per-bounce draws keyed by the lane's bounce row 15."""
    base = rng.bits_to_u32(st[13].detach())
    bounce = st[15].detach().to(torch.int64)
    return (rng.draw_uniform(base, bounce, 0, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 1, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 2, -1.0, 1.0),
            rng.draw_uniform(base, bounce, 3, 0.0, 1.0))


def _control(st, idx, cam, max_bounces: int):
    """The step's discrete closures -> (alive, live, sky, finished,
    has_more, s_next), as the JAX ``_step_tail`` computes them."""
    alive = st[12] > 0.5
    hit = idx >= 0
    live = alive & hit
    b_next = st[15] + 1.0
    finished = alive & ~(live & (b_next < float(max_bounces)))
    s_next = st[14] + torch.where(finished, 1.0, 0.0)
    has_more = finished & (s_next < cam[12])
    return alive, live, alive & ~hit, finished, has_more, s_next


def _is_tri(idx, table, n_tri: int):
    """Is the winner a triangle (its id past the spheres')? None for a
    sphere scene, so the shading takes no triangle branch."""
    return idx >= table.shape[0] - n_tri if n_tri else None


def step_tail_plain(st, cam, table, idx, *, use_sky: bool, max_bounces: int,
                    width: int, height: int, n_tri: int = 0):
    """Everything after the search (JAX ``_step_tail``): shading by the
    winner idx [R] (-1 = miss; a triangle when idx >= P - n_tri), the
    sample flush and the in-lane regeneration. st [24,R] -> (new state
    [24,R], record [R]: idx on live lanes, -1 elsewhere). Shared by the
    forward and the backward's replay, so the replay repeats the forward
    bit for bit; differentiable w.r.t. st rows 0-11 and 16-18, cam[0:12]
    and table under torch.autograd."""
    alive, live, sky, finished, has_more, s_next = _control(
        st, idx, cam, max_bounces)
    winner = table[idx.clamp(min=0).long()].T
    sh = shade_plain(st[0:16], winner, live, sky, _draws(st), use_sky,
                     _is_tri(idx, table, n_tri))

    total = st[16:19] + torch.where(finished, sh[9:12], 0.0)
    color = torch.where(finished, 0.0, sh[9:12])
    h1 = rng.bits_to_u32(st[21].detach())
    new_base = rng.sample_base(h1, s_next.detach().to(torch.int64))
    rd = film_rays(st[19], st[20], new_base, width, height, cam[0:3],
                   cam[3:6], cam[6:9], cam[9:12]).T
    o = torch.where(has_more, cam[0:3, None], sh[0:3])
    d = torch.where(has_more, rd, sh[3:6])
    atten = torch.where(has_more, 1.0, sh[6:9])
    new_alive = torch.where(finished, has_more.to(torch.float32), sh[12])
    base = torch.where(has_more, rng.u32_to_bits(new_base), st[13].detach())
    new_b = torch.where(finished, 0.0, st[15] + 1.0)
    rays = st[22] + alive.to(torch.float32)
    out = torch.cat([o, d, atten, color, new_alive[None], base[None],
                     s_next[None], new_b[None], total, st[19:22],
                     rays[None], st[23:24]], dim=0)
    return out, torch.where(live, idx, -1)


def _search(st, table, tri=None):
    """The exact nearest hit of every lane's ray over the spheres and then
    the triangles -> winner id in the one id space, -1 on a miss (no
    autograd history). A triangle wins only with a strictly smaller t, so
    an exact tie goes to the lower id."""
    n_sph = table.shape[0] - (0 if tri is None else tri.shape[0])
    o, d = st[0:3].T, st[3:6].T
    hit = nearest_hit(table[:n_sph, 0:3], table[:n_sph, 3], o, d)
    t, idx = hit.t, hit.idx.long()
    if tri is not None:
        th = nearest_hit_tri(tri, o, d)
        wins = th.t < t
        t = torch.where(wins, th.t, t)
        idx = torch.where(wins, th.idx.long() + n_sph, idx)
    return torch.where(t < float(F32_MAX), idx, -1)


def regen_steps_plain(state, cam, table, steps: int, *, use_sky: bool,
                      max_bounces: int, width: int, height: int,
                      seg: int | None = None, tri=None):
    """``steps`` wavefront steps over the [24, R] state, in place. A dead
    lane only advances its bounce row, so once every lane is dead the
    remaining steps are applied to that row at once. With ``seg``, also
    records (see module docstring) -> (state, Records); else -> state.
    tri: the triangle search table (the last M rows of table are the
    triangles), None for a sphere scene."""
    r = state.shape[1]
    dev = state.device
    if seg is not None:
        recs = Records(
            rec=torch.full((steps, r), -1, dtype=torch.int16, device=dev),
            chk=torch.zeros((-(-steps // seg), 24, r), dtype=torch.float32,
                            device=dev),
            t_end=torch.zeros(r, dtype=torch.int32, device=dev), seg=seg)
    kw = dict(use_sky=use_sky, max_bounces=max_bounces, width=width,
              height=height, n_tri=0 if tri is None else tri.shape[0])
    for k in range(steps):
        alive = state[12] > 0.5
        if not bool(alive.any()):
            state[15] += float(steps - k)
            break
        if seg is not None and k % seg == 0:
            recs.chk[k // seg] = state
        new, rec = step_tail_plain(state, cam, table,
                                   _search(state, table, tri), **kw)
        if seg is not None:
            recs.rec[k] = rec.to(torch.int16)
            recs.t_end.add_(alive.to(torch.int32))
        state.copy_(new)
    return state if seg is None else (state, recs)


def _check_regen_args(state, cam, table, n_tri: int = 0):
    dev = state.device
    build.require(state, "state", torch.float32, (24, state.shape[1]), dev)
    build.require(cam, "cam13", torch.float32, (13,), dev)
    build.require(table, "table", torch.float32, (table.shape[0], 12), dev)
    if not 0 <= n_tri <= table.shape[0]:
        raise ValueError(f"n_tri {n_tri} outside the table's "
                         f"{table.shape[0]} rows")
    return dev


def _check_ids(table):
    """The winner records are i16: the id space must stay below 2^15."""
    if table.shape[0] >= ID_LIMIT:
        raise ValueError(f"{table.shape[0]} primitives: the winner records "
                         f"are i16, at most {ID_LIMIT - 1}")


def _tri_args(tri, table, dev):
    """(pointer, M) of the triangle search table for the C entry points."""
    if tri is None:
        return None, 0
    build.require(tri, "tri", torch.float32, (tri.shape[0], 9), dev)
    if tri.shape[0] > table.shape[0]:
        raise ValueError("the table must hold a row per triangle")
    return tri.data_ptr(), tri.shape[0]


def regen_steps(state, cam, table, steps: int, *, use_sky: bool,
                max_bounces: int, width: int, height: int, tri=None):
    """K2: ``steps`` persistent-wavefront steps over the [24, R] f32 state,
    updated in place (search + shade + in-lane regeneration). cam: [13]
    f32 (``cam13``), table [P,12] f32, tri [M,9] f32 or None (see module
    docstring). CPU tensors take ``regen_steps_plain``."""
    if not state.is_cuda:
        return regen_steps_plain(state, cam, table, steps, use_sky=use_sky,
                                 max_bounces=max_bounces, width=width,
                                 height=height, tri=tri)
    dev = _check_regen_args(state, cam, table)
    tri_ptr, m = _tri_args(tri, table, dev)
    film_w, film_h = film_extent(width, height)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_steps(
            state.data_ptr(), state.shape[1], cam.data_ptr(),
            table.data_ptr(), table.shape[0], tri_ptr, m, int(steps),
            int(bool(use_sky)), int(max_bounces), int(width), int(height),
            float(film_w), float(film_h), build.stream_of(state))
    build.check("trt_regen_steps", err)
    regen_steps.launches += 1
    return state


regen_steps.launches = 0


def regen_record(state, cam, table, steps: int, seg: int, *, use_sky: bool,
                 max_bounces: int, width: int, height: int,
                 tri=None) -> Records:
    """K2 in recording mode: as ``regen_steps``, and also writes the
    winner records, the checkpoints every ``seg`` steps and t_end
    (``Records``). The state advances bit for bit as without recording.
    CPU tensors take ``regen_steps_plain(..., seg=seg)``."""
    _check_ids(table)
    if not state.is_cuda:
        return regen_steps_plain(state, cam, table, steps, use_sky=use_sky,
                                 max_bounces=max_bounces, width=width,
                                 height=height, seg=seg, tri=tri)[1]
    dev = _check_regen_args(state, cam, table)
    tri_ptr, m = _tri_args(tri, table, dev)
    r = state.shape[1]
    recs = Records(
        rec=torch.empty((steps, r), dtype=torch.int16, device=dev),
        chk=torch.empty((-(-steps // seg), 24, r), dtype=torch.float32,
                        device=dev),
        t_end=torch.empty(r, dtype=torch.int32, device=dev), seg=seg)
    film_w, film_h = film_extent(width, height)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_steps_record(
            state.data_ptr(), r, cam.data_ptr(), table.data_ptr(),
            table.shape[0], tri_ptr, m, int(steps), int(bool(use_sky)),
            int(max_bounces), int(width), int(height), float(film_w),
            float(film_h),
            recs.rec.data_ptr(), recs.chk.data_ptr(), recs.t_end.data_ptr(),
            int(seg), build.stream_of(state))
    build.check("trt_regen_steps_record", err)
    regen_record.launches += 1
    return recs


regen_record.launches = 0


def _step_vjp_plain(st, consts, idx, d_st, cam, table, *, use_sky: bool,
                    max_bounces: int, width: int, height: int,
                    n_tri: int = 0):
    """Transpose of one ``step_tail_plain`` at the pre-step state st
    [>=16,R] (consts: rows 19-21 of the state) -> (d_state before the
    step [24,R], d_winner [12,R], camera-row cotangents [12,R]).

    Routing as the JAX segment backward (``regen.py:610-684``): the
    regenerated origin/direction enter through where(has_more, ., shaded);
    rows 12-15, 19-21 and s_next carry no cotangent; the colour total's
    cotangent passes straight through and feeds the colour row where the
    sample finished."""
    _, live, sky, finished, has_more, s_next = _control(
        st, idx, cam, max_bounces)
    winner = table[idx.clamp(min=0).long()].T
    g_out, g_tot = d_st[0:12], d_st[16:19]
    g16 = torch.cat([torch.where(has_more, 0.0, g_out[0:9]),
                     torch.where(finished, g_tot, g_out[9:12]),
                     torch.zeros_like(g_out[0:4])])
    d_st16, d_wn = shade_vjp_plain(st[0:16], winner, live, sky, _draws(st),
                                   use_sky, g16, _is_tri(idx, table, n_tri))

    # regenerated direction d3 = normalize_eps(fc + fx cam_x + fy cam_y - pos)
    base = rng.sample_base(rng.bits_to_u32(consts[2]), s_next.to(torch.int64))
    fx, fy = film_offsets(consts[0], consts[1], base, width, height)
    rv = [((cam[3 + k] + fx * cam[6 + k]) + fy * cam[9 + k]) - cam[k]
          for k in range(3)]
    nx, ny, nz, inv, ok = nrm3_fwd(*rv)
    g_d3 = torch.where(has_more, g_out[3:6], 0.0)
    d_r = torch.stack(nrm3_bwd(nx, ny, nz, inv, ok, g_d3[0], g_d3[1],
                               g_d3[2]))
    d_cam = torch.cat([torch.where(has_more, g_out[0:3], 0.0) - d_r, d_r,
                       fx * d_r, fy * d_r])
    zeros = torch.zeros_like(g_out[0:4])
    d_prev = torch.cat([d_st16[0:12], zeros, g_tot, zeros, zeros[0:1]])
    return d_prev, d_wn, d_cam


def regen_bwd_plain(recs: Records, d_out, cam, table, *, use_sky: bool,
                    max_bounces: int, width: int, height: int,
                    n_tri: int = 0):
    """Reverse of a recorded trace (plain version of K3). For each segment
    from the last to the first: replay from its checkpoint with the
    recorded winners (no search), then sweep back through the step
    transposes. d_out [24,R]: cotangent of the final state (rows 0-11 and
    16-18 read); n_tri: the triangle rows at the end of table.
    -> (d_state at the start [24,R], d_table [P,12], d_cam [12]); d_table
    and d_cam are summed in f64, then rounded."""
    seg = recs.seg
    steps, r = recs.rec.shape
    kw = dict(use_sky=use_sky, max_bounces=max_bounces, width=width,
              height=height, n_tri=n_tri)
    d_st = torch.zeros_like(d_out)
    d_st[0:12] = d_out[0:12]
    d_st[16:19] = d_out[16:19]
    d_tab = torch.zeros(table.shape, dtype=torch.float64, device=d_out.device)
    d_cam = torch.zeros(12, dtype=torch.float64, device=d_out.device)
    t_end = recs.t_end.long()
    for s in reversed(range(recs.chk.shape[0])):
        t0, t1 = s * seg, min((s + 1) * seg, steps)
        act = t_end > t0
        if not bool(act.any()):
            continue
        st = torch.where(act, recs.chk[s], 0.0)
        consts = st[19:22]
        stash = []
        for t in range(t0, t1):
            valid = t < t_end
            idx = torch.where(valid, recs.rec[t].long(), -1)
            stash.append((st[0:16], idx, valid))
            st, _ = step_tail_plain(st, cam, table, idx, **kw)
        for st16, idx, valid in reversed(stash):
            d_prev, d_wn, d_c = _step_vjp_plain(st16, consts, idx, d_st, cam,
                                                table, **kw)
            d_st = torch.where(valid, d_prev, d_st)
            hit = valid & (idx >= 0)
            d_tab.index_add_(0, idx[hit], d_wn[:, hit].T.to(torch.float64))
            d_cam += torch.where(valid, d_c, 0.0).to(torch.float64).sum(1)
    return d_st, d_tab.to(torch.float32), d_cam.to(torch.float32)


def regen_bwd(recs: Records, d_out, cam, table, *, use_sky: bool,
              max_bounces: int, width: int, height: int, n_tri: int = 0):
    """K3: the reverse of a recorded trace (``regen_bwd_plain``'s contract)
    in two launches. d_table and d_cam are summed in f32 per block of
    lanes in a fixed order, then over the blocks in a second launch, so
    they are the same from run to run (``csrc/regen_bwd.cu``). CPU tensors
    take ``regen_bwd_plain``."""
    if not d_out.is_cuda:
        return regen_bwd_plain(recs, d_out, cam, table, use_sky=use_sky,
                               max_bounces=max_bounces, width=width,
                               height=height, n_tri=n_tri)
    steps, r = recs.rec.shape
    n_seg = recs.chk.shape[0]
    if not 1 <= recs.seg <= SEG_MAX:
        raise ValueError(f"seg must lie in [1, {SEG_MAX}], got {recs.seg}")
    _check_ids(table)
    dev = _check_regen_args(d_out, cam, table, n_tri)
    build.require(recs.rec, "rec", torch.int16, (steps, r), dev)
    build.require(recs.chk, "chk", torch.float32, (n_seg, 24, r), dev)
    build.require(recs.t_end, "t_end", torch.int32, (r,), dev)
    if n_seg != -(-steps // recs.seg):
        raise ValueError("chk holds ceil(steps/seg) checkpoints")
    lib = build.load()
    n = table.shape[0]
    parts = lib.trt_regen_bwd_parts(r)
    part = torch.empty((parts, n, 12), dtype=torch.float32, device=dev)
    part_cam = torch.empty((parts, 12), dtype=torch.float32, device=dev)
    d_state = d_out.clone()
    d_table = torch.empty_like(table)
    d_cam = torch.empty(12, dtype=torch.float32, device=dev)
    film_w, film_h = film_extent(width, height)
    with torch.cuda.device(dev):
        err = lib.trt_regen_bwd(
            d_state.data_ptr(), r, cam.data_ptr(), table.data_ptr(), n,
            int(n_tri), recs.rec.data_ptr(), recs.chk.data_ptr(),
            recs.t_end.data_ptr(), int(steps), int(recs.seg),
            int(bool(use_sky)), int(max_bounces), int(width), int(height),
            float(film_w), float(film_h), part.data_ptr(),
            part_cam.data_ptr(), d_table.data_ptr(), d_cam.data_ptr(),
            build.stream_of(d_out))
    build.check("trt_regen_bwd", err)
    regen_bwd.launches += 1
    return d_state, d_table, d_cam


regen_bwd.launches = 0


def regen_tables(scene: Scene):
    """The regen route's tables of the Morton-permuted scene ->
    (table [P,12], differentiable through the permutation; tri [M,9] or
    None; n_tri)."""
    sp = permute_scene(scene)
    table = prim_table(sp)
    if sp.tris is None:
        return table, None, 0
    return table, tri_search_table(sp.tris), sp.tris.n_pad


def trace_regen(scene: Scene, camera: Camera, pixel, *, width: int,
                height: int, spp: int, seed: int, max_bounces: int,
                sample_start: int = 0):
    """All ``spp`` samples of the pixel set through the persistent
    wavefront -> (color_sum [R,3], rays_cast int). One regen_steps call of
    spp * max_bounces steps: a sample takes at most max_bounces steps, so
    the cap never cuts a lane. No autograd history."""
    with torch.no_grad():
        table, tri, _ = regen_tables(scene)
        st, cam, _ = wave_init(camera, pixel, spp, seed, sample_start,
                               width, height)
        regen_steps(st, cam, table, spp * max_bounces,
                    use_sky=scene.use_sky, max_bounces=max_bounces,
                    width=width, height=height, tri=tri)
    return st[16:19].T, int(st[22].to(torch.int64).sum())


class RegenTrace(torch.autograd.Function):
    """The regen trace with its hand-written backward (the JAX custom VJP
    of ``make_regen_trace``).

    Differentiable inputs: the [P,12] winner table of the permuted scene,
    the 12 camera rows (position, film_center, cam_x, cam_y) and sample
    s0's primary origins/directions [R,3]; autograd carries their
    cotangents on through ``prim_table``, the permutation,
    ``Camera.basis`` and ``camera_rays``. The triangle search table rides
    along without a gradient (the search is a discrete choice). Forward:
    K2 in recording mode. Backward: K3. The records live in ``ctx`` until
    the backward has run."""

    @staticmethod
    def forward(ctx, table, rows, o0, d0, base0, pixel, tri, cfg):
        width, height, seed, max_bounces, spp, s0, seg, use_sky = cfg
        st = _init_state(o0, d0, base0, pixel, seed, s0, width)
        cam = torch.cat([rows, rows.new_tensor([float(s0 + spp)])])
        table = table.contiguous()
        recs = regen_record(st, cam, table, spp * max_bounces, seg,
                            use_sky=use_sky, max_bounces=max_bounces,
                            width=width, height=height, tri=tri)
        ctx.save_for_backward(table, cam, recs.rec, recs.chk, recs.t_end)
        ctx.cfg = cfg
        ctx.n_tri = 0 if tri is None else tri.shape[0]
        rays = st[22].to(torch.int64).sum()
        ctx.mark_non_differentiable(rays)
        return st[16:19].T.contiguous(), rays

    @staticmethod
    def backward(ctx, d_color, _):
        width, height, _, max_bounces, _, _, seg, use_sky = ctx.cfg
        table, cam, rec, chk, t_end = ctx.saved_tensors
        d_out = torch.zeros((24, d_color.shape[0]), dtype=torch.float32,
                            device=d_color.device)
        d_out[16:19] = d_color.T
        d_st, d_tab, d_cam = regen_bwd(
            Records(rec, chk, t_end, seg), d_out, cam, table,
            use_sky=use_sky, max_bounces=max_bounces, width=width,
            height=height, n_tri=ctx.n_tri)
        return (d_tab, d_cam[0:12], d_st[0:3].T, d_st[3:6].T, None, None,
                None, None)


@functools.lru_cache(maxsize=None)
def make_regen_trace(width: int, height: int, seed: int, max_bounces: int,
                     spp: int, seg: int = SEG_MAX):
    """Differentiable persistent-wavefront trace: (scene, camera, pixel, s0)
    -> (color_sum [R,3], rays_cast int).

    Where nothing asks for a gradient this is ``trace_regen`` (forward
    only). Otherwise ``RegenTrace``: the forward records every step's
    winner (k_max x R i16) and a [24,R] checkpoint every ``seg`` steps
    (seg is clamped to k_max = spp * max_bounces), and the backward replays
    and reverses it in K3."""
    k_max = spp * max_bounces
    seg = max(1, min(int(seg), k_max))
    if seg > SEG_MAX:
        raise ValueError(f"seg must be at most {SEG_MAX}, got {seg}")

    def trace(scene: Scene, camera: Camera, pixel, s0: int = 0):
        leaves = [scene.leaf(k) for k in scene.leaves] + [camera.position,
                                                          camera.look_at]
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in leaves)):
            return trace_regen(scene, camera, pixel, width=width,
                               height=height, spp=spp, seed=seed,
                               max_bounces=max_bounces, sample_start=s0)
        table, tri, _ = regen_tables(scene)
        cam_x, cam_y, _, film_center = camera.basis()
        rows = torch.cat([camera.position, film_center, cam_x, cam_y])
        o, d, base0 = camera_rays(camera, width, height, pixel, s0, seed)
        cfg = (width, height, seed, max_bounces, spp, int(s0), seg,
               scene.use_sky)
        color, rays = RegenTrace.apply(table, rows, o, d, base0, pixel, tri,
                                       cfg)
        return color, int(rays)

    return trace
