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

K2 has two triangle modes, named by the caller as JAX's caller names
them: after the spheres each step folds triangles, and the winner is the
lowest id in the one primitive id space (spheres 0..N-1, triangles
N..N+M-1) on an exact tie.
- The listed mode (``tri`` and its tile boxes ``boxes``) replaces
  ``regen_step(tri_lists=...)`` (``_regen_list_kernel``): at every step
  each 256-lane block lists the 128-triangle tiles its live lanes' rays can
  reach (``bounce_step.tri_block_lists`` at group 1, built in the launch
  where JAX builds them on the host, ``_step_lists``) and folds only
  those. The route takes it for every triangle scene it runs.
- The sweep (``tri`` without boxes) replaces ``regen_step(tri_tab=,
  tri_lists=None)`` (``_regen_kernel``'s triangle tiles): every live lane
  folds every triangle.
A list leaves out only tiles whose inflated box no live lane of the block
meets, so the two modes differ only where Möller-Trumbore accepts a
grazing hit outside its tile's box.

On a sphere scene the route takes K2's culled sphere search (``sph``, the
tiles of ``sphere_tiles``): a lane folds a 16-sphere tile of the
Morton-permuted table only where its ray enters the tile's inflated box
at no more than its best so far, which changes no winner
(``nearest_sphere_culled`` is its plain mirror, held bit for bit to
``regen_steps_plain``, the yardstick, which folds every sphere). Without
``sph`` the sphere mode folds every sphere, as before the cull.

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

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, film_extent
from tpu_ray_torch.core.scene import F32_EPS, F32_MAX, Scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, MERGE_STATS,
                                               _block_reach,
                                               nearest_prim, nrm3_bwd,
                                               nrm3_fwd, permute_scene,
                                               prim_table, shade_plain,
                                               shade_vjp_plain,
                                               tab_tile_boxes)
from tpu_ray_torch.ops.intersect_tri import tri_search_table
from tpu_ray_torch.ops.raygen import camera_rays, film_offsets, film_rays
from tpu_ray_torch.ops.vec import safe_sqrt

__all__ = ["regen_steps", "regen_steps_plain", "regen_record",
           "regen_bwd", "regen_bwd_plain", "step_tail_plain", "wave_init",
           "cam13", "trace_regen", "make_regen_trace", "RegenTrace",
           "Records", "SEG_MAX", "regen_tables", "SphereTiles",
           "sphere_tiles", "nearest_sphere_culled", "culled_sphere_fold",
           "regen_bwd_info"]

_EPS, _MAX = float(F32_EPS), float(F32_MAX)

# the longest segment K3 replays (its per-lane stash is sized for it)
SEG_MAX = 64
# winner records are i16: the primitive id space must stay below 2^15
ID_LIMIT = 2 ** 15


# K2's sphere mode folds the sphere table in tiles of this many spheres
# (16 gives rtweekend's 482 spheres 34 tiles, and a half warp holds a
# tile, so the warp shares a tile's fold two lanes at a time;
# tools/cull_variants.py times 32, and other group sizes, from patched
# copies)
SPH_TILE = 16
# consecutive tiles a group box holds: a lane tests a group's tiles only
# where its ray enters the group's box at no more than its best
SPH_GROUP = 4
# a sphere of more than this many times the median radius of the real
# spheres gets a tile of its own (rtweekend's ground: 5,000 times)
SPH_ISOLATE = 16.0
# the sphere boxes' inflation, relative to |centre|_inf + radius + the
# origin bound: 168 f32 roundings (2^-24) of that size, where the hit
# point of a computed t and the slab test's entry need ~60 (sphere_tiles)
SPH_PAD = 1e-5


class SphereTiles(NamedTuple):
    """K2's sphere tiles (``sphere_tiles``)."""
    boxes: torch.Tensor   # [T,6] f32 lo|hi, inflated; lo > hi: empty
    starts: torch.Tensor  # [T+1] i32: tile t holds [starts[t], starts[t+1])
    gboxes: torch.Tensor  # [G,6] f32: the union of each group's tile boxes
    gstarts: torch.Tensor  # [G+1] i32: group g holds tiles [gs[g], gs[g+1])
    o_lim: float          # the origin bound (|o|_inf) the boxes hold for
    n: int                # the sphere table's rows


def _f32_down(x: float) -> float:
    """The largest f32 value at most x."""
    f = torch.tensor(x, dtype=torch.float32)
    if float(f) > x:
        f = torch.nextafter(f, torch.tensor(float("-inf")))
    return float(f)


@torch.no_grad()
def sphere_tiles(table, origin_bound: float = 0.0) -> SphereTiles:
    """Tiles of a sphere table [N,12] (the Morton-permuted scene's, so a
    tile is spatially compact) and their boxes, for K2's culled search.

    Consecutive spheres form tiles of at most SPH_TILE; a sphere whose
    radius exceeds SPH_ISOLATE times the median real radius gets a tile of
    its own (rtweekend's ground, 62.5 against 0.0125, sits mid-table after
    the permutation and would widen its neighbours' box to every ray), and
    padding (radius 0) starts tiles of its own. The tiles cover the table
    in ascending id order, so a fold over them with strict < keeps the
    lowest id on an exact tie. A tile's box is the union of its real
    spheres' boxes, centre +- (radius + pad); a padding-only tile gets an
    empty box (lo = 1e30 > hi = -1e30), which the kernel never enters.

    The pad covers f32 rounding: the point o + t d at a t the fold computes
    lies within radius + ~30 u (|m| + r) of the centre (m = c - o, u =
    2^-24; the far root of a ray that starts inside included), and the
    slab test's entry may round ~3 u t late, so a box inflated by ~60 u
    (|c| + |o| + r) still holds the entry at or before that t, and a tile
    the kernel skips cannot hold a lane's nearest hit. pad = SPH_PAD (|c|_inf
    + r + o_lim) allows 168 u. o_lim bounds the origins: the scene's
    extent (every hit point lies on a sphere) and ``origin_bound`` (the
    camera's |position|_inf, where regenerated rays start); a lane whose
    origin lies past it folds every tile.

    Groups of at most SPH_GROUP consecutive tiles (a tile of its own
    sphere, or of padding, is a group of its own) get the union of their
    boxes: f32 rounding is monotone, so a ray's entry into a group's box is
    at most its entry into each of the group's tiles, and a lane that
    skips a group skips only tiles it would skip one by one."""
    cr = table[:, 0:4].detach().to("cpu", torch.float64)    # one copy
    c, rad = cr[:, 0:3], cr[:, 3]
    n = rad.shape[0]
    valid = rad > 0.0
    size = c.abs().amax(dim=1) + rad
    reach = float(size[valid].max()) if bool(valid.any()) else 0.0
    o_lim = _f32_down(max(reach * (1.0 + 1e-6), float(origin_bound)))
    big = (valid & (rad > SPH_ISOLATE * rad[valid].median())
           if bool(valid.any()) else valid)
    v, b = valid.tolist(), big.tolist()
    starts = [0]
    for i in range(1, n):
        if (i - starts[-1] == SPH_TILE or b[i] or b[i - 1]
                or v[i] != v[i - 1]):
            starts.append(i)
    starts.append(n)
    ext = (rad + SPH_PAD * (size + o_lim))[:, None]
    lo = torch.where(valid[:, None], c - ext, _MAX)
    hi = torch.where(valid[:, None], c + ext, -_MAX)
    boxes = _span_boxes(lo, hi, starts)
    alone = [b[a] or not v[a] for a in starts[:-1]]
    gstarts = [0]
    for t in range(1, len(alone)):
        if t - gstarts[-1] == SPH_GROUP or alone[t] or alone[t - 1]:
            gstarts.append(t)
    gstarts.append(len(alone))
    gboxes = _span_boxes(boxes[:, 0:3], boxes[:, 3:6], gstarts)
    # two copies to the device: the boxes, then the starts
    dev, n_t = table.device, len(starts) - 1
    f = torch.cat([boxes, gboxes]).to(dev, torch.float32)
    i = torch.tensor(starts + gstarts, dtype=torch.int32).to(dev)
    return SphereTiles(f[:n_t], i[:n_t + 1], f[n_t:], i[n_t + 1:], o_lim, n)


def _span_boxes(lo, hi, starts):
    """The union box of each span [starts[k], starts[k + 1]) of the rows of
    lo, hi [N,3] -> [len(starts) - 1, 6] lo|hi."""
    spans = torch.as_tensor(starts)
    which = torch.repeat_interleave(torch.arange(spans.shape[0] - 1),
                                    spans.diff())[:, None].expand(-1, 3)
    out = torch.empty((spans.shape[0] - 1, 6), dtype=lo.dtype)
    out[:, 0:3] = torch.full_like(out[:, 0:3], _MAX).scatter_reduce_(
        0, which, lo, "amin")
    out[:, 3:6] = torch.full_like(out[:, 3:6], -_MAX).scatter_reduce_(
        0, which, hi, "amax")
    return out


def _box_entry(boxes, o, d, inv):
    """Plain version of common.cuh trt_box_entry for the rays o, d [R,3]
    (inv: 1 / d, 0 where d = 0) and the boxes [B,6] -> entry [R,B] f32:
    where each ray enters each box, +inf where it surely misses (or the box
    is empty), 0 where a NaN leaves it unsure."""
    inf = float("inf")
    o, d, inv = o[:, None, :], d[:, None, :], inv[:, None, :]
    tl = torch.zeros((o.shape[0], boxes.shape[0]), dtype=o.dtype,
                     device=o.device)
    th = torch.full_like(tl, 3.0e38)
    nan = torch.zeros_like(tl, dtype=torch.bool)
    out = torch.zeros_like(nan)
    for k in range(3):
        lo, hi = boxes[None, :, k], boxes[None, :, 3 + k]
        ok, dk = o[..., k], d[..., k]
        par = dk == 0.0
        out |= par & ~((ok >= lo) & (ok <= hi))
        a0 = (lo - ok) * inv[..., k]
        a1 = (hi - ok) * inv[..., k]
        nan |= ~par & (torch.isnan(a0) | torch.isnan(a1))
        tl = torch.where(par, tl, torch.maximum(tl, torch.minimum(a0, a1)))
        th = torch.where(par, th, torch.minimum(th, torch.maximum(a0, a1)))
    meet = (th >= tl) & (th >= 0.0)
    entry = torch.where(nan, 0.0, torch.where(meet, tl, inf))
    return torch.where(out | ~(boxes[None, :, 0] <= boxes[None, :, 3]), inf,
                       entry)


@torch.no_grad()
def nearest_sphere_culled(st, table, sph: SphereTiles):
    """Plain version of K2's culled sphere search (common.cuh
    trt_fold_sph_tiles), lane for lane: the tiles in ascending order, a
    live lane folding a tile only where its ray enters the tile's box at
    no more than its best so far (every tile where its origin lies past
    o_lim), and a group's tiles only where its ray enters the group's box
    at no more than its best (a group of one tile is not tested apart).
    -> (winner id [R] int64, -1 on a miss; counts [3] int64: boxes tested
    (groups and tiles), tiles folded, ray-sphere pairs tested over the
    live lanes). The winner is ``nearest_prim``'s (the test of the
    culling)."""
    best, bi, counts = culled_sphere_fold(st, table, sph)
    return torch.where(best < _MAX, bi, -1), counts


@torch.no_grad()
def culled_sphere_fold(st, table, sph: SphereTiles):
    """``nearest_sphere_culled``'s fold -> (best t [R] f32, F32_MAX on a
    miss or a dead lane; its sphere id [R] int64, 0 there; counts [3]
    int64), the running (best, bi) that K4's triangle mode goes on to
    fold the triangles into. Every pair's t and every box entry are taken
    at once (the same f32 values as one at a time); the tiles are then
    walked in order."""
    o, d = st[0:3].T, st[3:6].T
    active = st[12] > 0.5
    inv = torch.where(d != 0.0, torch.ones_like(d) / d, 0.0)
    cull = active & (o.abs().amax(dim=1) <= sph.o_lim)
    # ops/intersect.nearest_hit's pair values, every sphere at once
    c, rad = table[:, 0:3], table[:, 3]
    mx, my, mz = (c[None, :, k] - o[:, k:k + 1] for k in range(3))
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    tp = mx * dx + my * dy + mz * dz
    px, py, pz = mx - dx * tp, my - dy * tp, mz - dz * tp
    dsq = px * px + py * py + pz * pz
    r2 = (rad * rad)[None, :]
    x = safe_sqrt(r2 - dsq)
    tn = tp - x
    t_all = torch.where(tn < _EPS, tp + x, tn)
    t_all = torch.where((dsq < r2) & (t_all > _EPS), t_all, _MAX)
    entry = _box_entry(sph.boxes.to(st.device), o, d, inv)
    gentry = _box_entry(sph.gboxes.to(st.device), o, d, inv)
    best = torch.full_like(o[:, 0], _MAX)
    bi = torch.zeros_like(best, dtype=torch.int64)
    starts, gstarts = sph.starts.tolist(), sph.gstarts.tolist()
    boxes_tested = torch.zeros_like(bi)
    folded = torch.zeros_like(bi)
    pairs = torch.zeros_like(bi)
    for g, (t0, t1) in enumerate(zip(gstarts[:-1], gstarts[1:])):
        in_g = active
        if t1 - t0 > 1:
            in_g = active & (~cull | (gentry[:, g] <= best))
            boxes_tested += cull
        for t in range(t0, t1):
            j0, j1 = starts[t], starts[t + 1]
            boxes_tested += in_g & cull
            need = in_g & (~cull | (entry[:, t] <= best))
            folded += need
            pairs += need * (j1 - j0)
            tmin, imin = torch.min(t_all[:, j0:j1], dim=1)
            take = need & (tmin < best)
            best = torch.where(take, tmin, best)
            bi = torch.where(take, imin + j0, bi)
    counts = torch.stack([boxes_tested.sum(), folded.sum(), pairs.sum()])
    return best, bi, counts


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


def regen_steps_plain(state, cam, table, steps: int, *, use_sky: bool,
                      max_bounces: int, width: int, height: int,
                      seg: int | None = None, tri=None, boxes=None,
                      sph: SphereTiles | None = None, stats=None):
    """``steps`` wavefront steps over the [24, R] state, in place. A dead
    lane only advances its bounce row, so once every lane is dead the
    remaining steps are applied to that row at once. With ``seg``, also
    records (see module docstring) -> (state, Records); else -> state.
    tri: the triangle search table (the last M rows of table are the
    triangles), None for a sphere scene. boxes: its tile boxes [T,6]
    (``bounce_step.tab_tile_boxes``) for the listed mode, where each step
    lists every BLOCK_R-lane block's reachable tiles from that step's
    state (``tri_block_lists``) and each live lane folds only its block's
    (a slice of lanes lists as whole blocks of its own); None for the
    sweep of every triangle. sph: a sphere scene's tiles (``sphere_tiles``)
    for the mirror of K2's culled search (``nearest_sphere_culled``, the
    same winners), stats then an int64 [3] tensor its counts are added
    to; None folds every sphere."""
    if sph is not None and tri is not None:
        raise ValueError("sphere tiles are for sphere scenes")
    r = state.shape[1]
    dev = state.device
    blk = torch.arange(r, device=dev) // BLOCK_R
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
        if sph is not None:
            idx, cnt = nearest_sphere_culled(state, table, sph)
            if stats is not None:
                stats += cnt.to(stats.device)
        else:
            tiles = (None if boxes is None
                     else _block_reach(boxes, state)[blk])
            idx = nearest_prim(state, table, tri, tiles)
        new, rec = step_tail_plain(state, cam, table, idx, **kw)
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


def _tri_args(tri, boxes, stats, table, dev):
    """(pointer, M, boxes pointer, T, stats pointer) of the triangle search
    table, its tile boxes and the listed mode's counters for the C entry
    points."""
    if tri is None:
        if boxes is not None or stats is not None:
            raise ValueError("tile boxes and stats need a triangle table")
        return None, 0, None, 0, None
    if boxes is None and stats is not None:
        raise ValueError("stats count the listed mode's tiles: give the "
                         "tile boxes")
    m = tri.shape[0]
    build.require(tri, "tri", torch.float32, (m, 9), dev)
    if m > table.shape[0]:
        raise ValueError("the table must hold a row per triangle")
    if boxes is None:
        return tri.data_ptr(), m, None, 0, None
    n_t = boxes.shape[0]
    build.require(boxes, "boxes", torch.float32, (n_t, 6), dev)
    if n_t < 1 or m % n_t:
        raise ValueError(f"{m} triangles in {n_t} tiles")
    if stats is not None:
        build.require(stats, "stats", torch.int64, (3,), dev)
    return (tri.data_ptr(), m, boxes.data_ptr(), n_t,
            None if stats is None else stats.data_ptr())


def _check_sph(sph: SphereTiles, table, tri, stats, dev):
    """Check the sphere tiles and counters of the culled sphere mode."""
    if tri is not None:
        raise ValueError("sphere tiles are for sphere scenes")
    if sph.n != table.shape[0]:
        raise ValueError(f"sphere tiles of {sph.n} spheres for a table of "
                         f"{table.shape[0]}")
    n_t, n_g = sph.boxes.shape[0], sph.gboxes.shape[0]
    build.require(sph.boxes, "sph.boxes", torch.float32, (n_t, 6), dev)
    build.require(sph.starts, "sph.starts", torch.int32, (n_t + 1,), dev)
    build.require(sph.gboxes, "sph.gboxes", torch.float32, (n_g, 6), dev)
    build.require(sph.gstarts, "sph.gstarts", torch.int32, (n_g + 1,), dev)
    if stats is not None:
        build.require(stats, "stats", torch.int64, (3,), dev)


def _regen_sph(state, cam, table, steps: int, sph: SphereTiles, tri, stats,
               use_sky: bool, max_bounces: int, width: int, height: int,
               recs=None) -> None:
    """K2's sphere mode with the culled search, forward or (recs) the
    recording mode, on CUDA tensors."""
    dev = _check_regen_args(state, cam, table)
    _check_sph(sph, table, tri, stats, dev)
    film_w, film_h = film_extent(width, height)
    rec_args = ((None, None, None, 1) if recs is None else
                (recs.rec.data_ptr(), recs.chk.data_ptr(),
                 recs.t_end.data_ptr(), int(recs.seg)))
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_sph(
            state.data_ptr(), state.shape[1], cam.data_ptr(),
            table.data_ptr(), table.shape[0], sph.boxes.data_ptr(),
            sph.starts.data_ptr(), sph.boxes.shape[0], sph.gboxes.data_ptr(),
            sph.gstarts.data_ptr(), sph.gboxes.shape[0], float(sph.o_lim),
            None if stats is None else stats.data_ptr(),
            int(steps), int(bool(use_sky)), int(max_bounces), int(width),
            int(height), float(film_w), float(film_h), *rec_args,
            build.stream_of(state))
    build.check("trt_regen_sph", err)


def regen_steps(state, cam, table, steps: int, *, use_sky: bool,
                max_bounces: int, width: int, height: int, tri=None,
                boxes=None, stats=None, sph: SphereTiles | None = None):
    """K2: ``steps`` persistent-wavefront steps over the [24, R] f32 state,
    updated in place (search + shade + in-lane regeneration). cam: [13]
    f32 (``cam13``), table [P,12] f32, tri [M,9] f32 or None, boxes [T,6]
    f32 (the listed mode) or None (the sweep; see module docstring).
    sph: a sphere scene's tiles (``sphere_tiles``): the culled search,
    which the route takes on every sphere scene; without them the sphere
    mode folds every sphere (the sweep it replaced, kept to time against).
    stats: None, or an int64 [3] CUDA tensor that the listed mode adds its
    counts to: listed tiles summed over the live block-steps, live
    block-steps, ray-triangle pairs tested; the culled sphere mode: tile
    boxes tested, tiles folded, ray-sphere pairs tested over the live
    lane-steps. CPU tensors take ``regen_steps_plain``, which folds every
    sphere (the culled search gives its winners)."""
    if not state.is_cuda:
        if stats is not None:
            raise ValueError("stats are counted by the kernel only")
        return regen_steps_plain(state, cam, table, steps, use_sky=use_sky,
                                 max_bounces=max_bounces, width=width,
                                 height=height, tri=tri, boxes=boxes)
    if sph is not None:
        _regen_sph(state, cam, table, steps, sph, tri, stats, use_sky,
                   max_bounces, width, height)
        regen_steps.launches += 1
        regen_steps.culled_launches += 1
        return state
    dev = _check_regen_args(state, cam, table)
    tri_ptr, m, box_ptr, n_t, st_ptr = _tri_args(tri, boxes, stats, table,
                                                 dev)
    film_w, film_h = film_extent(width, height)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_steps(
            state.data_ptr(), state.shape[1], cam.data_ptr(),
            table.data_ptr(), table.shape[0], tri_ptr, m, box_ptr, n_t,
            st_ptr, int(steps), int(bool(use_sky)), int(max_bounces),
            int(width), int(height), float(film_w), float(film_h),
            build.stream_of(state))
    build.check("trt_regen_steps", err)
    regen_steps.launches += 1
    regen_steps.listed_launches += boxes is not None
    return state


# launches of every mode, and of the listed and culled sphere modes among
# them
regen_steps.launches = 0
regen_steps.listed_launches = 0
regen_steps.culled_launches = 0


def regen_record(state, cam, table, steps: int, seg: int, *, use_sky: bool,
                 max_bounces: int, width: int, height: int, tri=None,
                 boxes=None, stats=None,
                 sph: SphereTiles | None = None) -> Records:
    """K2 in recording mode: as ``regen_steps``, and also writes the
    winner records, the checkpoints every ``seg`` steps and t_end
    (``Records``). The state advances bit for bit as without recording.
    CPU tensors take ``regen_steps_plain(..., seg=seg)``."""
    _check_ids(table)
    if not state.is_cuda:
        if stats is not None:
            raise ValueError("stats are counted by the kernel only")
        return regen_steps_plain(state, cam, table, steps, use_sky=use_sky,
                                 max_bounces=max_bounces, width=width,
                                 height=height, seg=seg, tri=tri,
                                 boxes=boxes)[1]
    dev = _check_regen_args(state, cam, table)
    r = state.shape[1]
    recs = Records(
        rec=torch.empty((steps, r), dtype=torch.int16, device=dev),
        chk=torch.empty((-(-steps // seg), 24, r), dtype=torch.float32,
                        device=dev),
        t_end=torch.empty(r, dtype=torch.int32, device=dev), seg=seg)
    if sph is not None:
        _regen_sph(state, cam, table, steps, sph, tri, stats, use_sky,
                   max_bounces, width, height, recs)
        regen_record.launches += 1
        regen_record.culled_launches += 1
        return recs
    tri_ptr, m, box_ptr, n_t, st_ptr = _tri_args(tri, boxes, stats, table,
                                                 dev)
    film_w, film_h = film_extent(width, height)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_regen_steps_record(
            state.data_ptr(), r, cam.data_ptr(), table.data_ptr(),
            table.shape[0], tri_ptr, m, box_ptr, n_t, st_ptr, int(steps),
            int(bool(use_sky)),
            int(max_bounces), int(width), int(height), float(film_w),
            float(film_h),
            recs.rec.data_ptr(), recs.chk.data_ptr(), recs.t_end.data_ptr(),
            int(seg), build.stream_of(state))
    build.check("trt_regen_steps_record", err)
    regen_record.launches += 1
    regen_record.listed_launches += boxes is not None
    return recs


regen_record.launches = 0
regen_record.listed_launches = 0
regen_record.culled_launches = 0


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
              max_bounces: int, width: int, height: int, n_tri: int = 0,
              stats=None):
    """K3: the reverse of a recorded trace (``regen_bwd_plain``'s contract)
    in two launches. d_table and d_cam are summed in f32 per block of
    lanes in a fixed order (``bounce_step.table_sum_fixed_order``, each
    step's lane tile in turn), then over the blocks in a second launch, so
    they are the same from run to run (``csrc/regen_bwd.cu``). A table
    whose [n,12] partial row fits 96 KB sums in shared memory; a larger
    one (every triangle scene) in the block's row of the partials in
    global memory, one merge a step, writing only the entries the block
    touches and summing only those. stats: None, or int64
    [MERGE_STATS] on the card, added to in that global-row branch
    (``csrc/shade.cuh`` ``trt_row_merge_end``). CPU tensors take
    ``regen_bwd_plain`` (stats must be None)."""
    if not d_out.is_cuda:
        if stats is not None:
            raise ValueError("stats are the kernel's: CUDA tensors only")
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
    if stats is not None:
        build.require(stats, "stats", torch.int64, (MERGE_STATS,), dev)
    lib = build.load()
    n = table.shape[0]
    parts = lib.trt_regen_bwd_parts(r, n)
    part = torch.empty((parts, n, 12), dtype=torch.float32, device=dev)
    touched = torch.empty((parts, -(-n // 32)), dtype=torch.int32,
                          device=dev)
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
            touched.data_ptr(), part_cam.data_ptr(), d_table.data_ptr(),
            d_cam.data_ptr(), None if stats is None else stats.data_ptr(),
            build.stream_of(d_out))
    build.check("trt_regen_bwd", err)
    regen_bwd.launches += 1
    return d_state, d_table, d_cam


regen_bwd.launches = 0


def regen_bwd_info(n: int, device=None) -> dict:
    """K3's launch-1 kernel for a table of n rows as the card runs it:
    registers and local memory a thread (bytes: the stash and any spills),
    blocks an SM holds (the occupancy calculator), threads and dynamic
    shared memory a block, warps an SM, and the card's SMs. Needs a CUDA
    device."""
    lib = build.load()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device or torch.cuda.current_device()):
        build.check("trt_regen_bwd_info",
                    lib.trt_regen_bwd_info(int(n), ctypes.addressof(out)))
    regs, local, blocks, threads, smem, sms = list(out)
    return dict(registers=regs, local_bytes=local, blocks_per_sm=blocks,
                threads=threads, smem_bytes=smem, sms=sms,
                warps_per_sm=blocks * threads // 32)


def regen_tables(scene: Scene):
    """The regen route's tables of the Morton-permuted scene ->
    (table [P,12], differentiable through the permutation; tri [M,9] or
    None; n_tri). The listed mode's tile boxes are
    ``bounce_step.tab_tile_boxes(tri)``; a sphere scene's tiles, with
    their boxes, ``sphere_tiles(table, camera bound)`` (``_search_of``)."""
    sp = permute_scene(scene)
    table = prim_table(sp)
    if sp.tris is None:
        return table, None, 0
    return table, tri_search_table(sp.tris), sp.tris.n_pad


def _search_of(table, tri, camera: Camera):
    """The route's search tables beyond the winner table: a triangle
    scene's tile boxes (the listed mode), or a sphere scene's tiles (the
    culled sphere mode, its origins bounded by the camera's) -> (boxes,
    sph), one of them None."""
    if tri is not None:
        return tab_tile_boxes(tri), None
    bound = float(camera.position.detach().abs().max())
    return None, sphere_tiles(table, bound)


def trace_regen(scene: Scene, camera: Camera, pixel, *, width: int,
                height: int, spp: int, seed: int, max_bounces: int,
                sample_start: int = 0):
    """All ``spp`` samples of the pixel set through the persistent
    wavefront -> (color_sum [R,3], rays_cast int). One regen_steps call of
    spp * max_bounces steps: a sample takes at most max_bounces steps, so
    the cap never cuts a lane. A triangle scene takes the listed mode, a
    sphere scene the culled sphere mode. No autograd history."""
    with torch.no_grad():
        table, tri, _ = regen_tables(scene)
        boxes, sph = _search_of(table, tri, camera)
        st, cam, _ = wave_init(camera, pixel, spp, seed, sample_start,
                               width, height)
        regen_steps(st, cam, table, spp * max_bounces,
                    use_sky=scene.use_sky, max_bounces=max_bounces,
                    width=width, height=height, tri=tri, boxes=boxes,
                    sph=sph)
    return st[16:19].T, int(st[22].to(torch.int64).sum())


class RegenTrace(torch.autograd.Function):
    """The regen trace with its hand-written backward (the JAX custom VJP
    of ``make_regen_trace``).

    Differentiable inputs: the [P,12] winner table of the permuted scene,
    the 12 camera rows (position, film_center, cam_x, cam_y) and sample
    s0's primary origins/directions [R,3]; autograd carries their
    cotangents on through ``prim_table``, the permutation,
    ``Camera.basis`` and ``camera_rays``. The triangle search table and
    its tile boxes, or a sphere scene's tiles, ride along without a
    gradient (the search is a discrete choice). Forward: K2 in recording
    mode (the listed mode on a triangle scene, the culled sphere mode on a
    sphere scene). Backward: K3. The records live in ``ctx`` until the
    backward has run."""

    @staticmethod
    def forward(ctx, table, rows, o0, d0, base0, pixel, tri, boxes, sph,
                cfg):
        width, height, seed, max_bounces, spp, s0, seg, use_sky = cfg
        st = _init_state(o0, d0, base0, pixel, seed, s0, width)
        cam = torch.cat([rows, rows.new_tensor([float(s0 + spp)])])
        table = table.contiguous()
        recs = regen_record(st, cam, table, spp * max_bounces, seg,
                            use_sky=use_sky, max_bounces=max_bounces,
                            width=width, height=height, tri=tri,
                            boxes=boxes, sph=sph)
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
                None, None, None, None)


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
        boxes, sph = _search_of(table, tri, camera)
        color, rays = RegenTrace.apply(table, rows, o, d, base0, pixel, tri,
                                       boxes, sph, cfg)
        return color, int(rays)

    return trace
