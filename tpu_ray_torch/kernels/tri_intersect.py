"""The triangle search kernels: K7, the full sweep (``csrc/tri_intersect.cu``),
and K10, the listed search past the residency rule (``csrc/tri_stream.cu``).

K7 replaces ``tpu_ray/kernels/tri_intersect.py::nearest_hit_tri_pallas``;
its plain version is ``ops/intersect_tri.nearest_hit_tri``. K10 replaces
``nearest_hit_tri_stream``; its plain version is ``tri_stream_plain``. Each
wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_ray_torch.core.scene import F32_MAX
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.bounce_step import BLOCK_R, _block_reach, init_state
from tpu_ray_torch.ops.intersect import Hit
from tpu_ray_torch.ops.intersect_tri import _SLAB_ELEMS, _mt_slab
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri as tri_hit_plain

__all__ = ["tri_nearest_hit", "tri_slices", "tri_hit_plain",
           "tri_nearest_hit_stream", "tri_stream_plain"]

_MAX = float(F32_MAX)


def tri_slices(r: int, m: int, device=None) -> int:
    """The triangle slices K7 splits a launch of r rays over m triangles
    into on the card (``csrc/tri_intersect.cu`` trt_tri_slices: 1 where
    the ray blocks alone fill the card for several waves, else enough
    slices of at least 128 triangles to do so)."""
    lib = build.load()
    with torch.cuda.device(device):
        n = lib.trt_tri_slices(int(r), int(m))
    build.check("trt_tri_slices", 0 if n > 0 else -n)
    return n


def tri_nearest_hit(tab, origin, direction, *, slices: Optional[int] = None
                    ) -> Hit:
    """tab: the triangles' ``tri_search_table`` [M,9] f32; origin/direction
    [R,3] f32 -> Hit(t [R] f32, idx [R] i32): the exact nearest
    Möller-Trumbore hit, lowest index on ties. Neither output carries
    autograd history (the search is a discrete choice). slices: the
    number of triangle slices K7 splits the sweep into (None: chosen from
    the shapes, ``tri_slices``); the result is the same at any count."""
    if not origin.is_cuda:
        return tri_hit_plain(tab, origin, direction)
    m, r = tab.shape[0], origin.shape[0]
    dev = origin.device
    build.require(tab, "tri", torch.float32, (m, 9), dev)
    build.require(origin, "origin", torch.float32, (r, 3), dev)
    build.require(direction, "direction", torch.float32, (r, 3), dev)
    n_s = tri_slices(r, m, dev) if slices is None else int(slices)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    keys = (torch.empty(r, dtype=torch.int64, device=dev) if n_s > 1
            else None)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_tri_nearest_hit(
            tab.data_ptr(), m, origin.data_ptr(), direction.data_ptr(), r,
            n_s, None if keys is None else keys.data_ptr(), t.data_ptr(),
            idx.data_ptr(), build.stream_of(origin))
    build.check("trt_tri_nearest_hit", err)
    tri_nearest_hit.launches += 1
    return Hit(t=t, idx=idx)


tri_nearest_hit.launches = 0


@torch.no_grad()
def tri_stream_plain(tab, boxes, origin, direction, alive=None,
                     lanes: Optional[torch.Tensor] = None) -> Hit:
    """Plain version of K10: the nearest triangle hit of each alive lane
    over the tiles its BLOCK_R-lane block lists (``tri_block_lists`` at
    group 1, built from every alive lane of the launch). tab [M,9] the
    ``tri_search_table``, boxes [T,6] ``tri_tile_boxes``, origin/direction
    [R,3], alive [R] bool (None: every lane). -> Hit(t, idx) as
    ``nearest_hit_tri`` gives them; a dead lane, or one whose block lists
    nothing, misses (t = F32_MAX, idx 0). lanes: optional lane ids, whose
    results alone are returned, each still searched over its full-launch
    block's list.

    Each lane is tested against its block's listed triangles only,
    gathered in ascending id (a tie goes to the first, the lowest id), in
    slabs of lanes sorted by list length, so the work follows the lists
    and no [R,M] sweep is masked."""
    r, m, n_t = origin.shape[0], tab.shape[0], boxes.shape[0]
    dev = origin.device
    block_m = m // n_t
    act = (torch.ones(r, dtype=torch.bool, device=dev) if alive is None
           else alive.to(torch.bool))
    st = init_state(origin, direction,
                    torch.zeros(r, dtype=torch.int64, device=dev))
    st[12] = act.to(torch.float32)
    reach = _block_reach(boxes, st)                              # [B,T]
    cnt = reach.sum(dim=1)
    lst = torch.argsort((~reach).to(torch.uint8), dim=1, stable=True)
    sel = torch.arange(r, device=dev) if lanes is None else lanes.to(dev)
    t_out = torch.full((sel.shape[0],), _MAX, dtype=torch.float32,
                       device=dev)
    idx_out = torch.zeros(sel.shape[0], dtype=torch.int32, device=dev)
    pos = torch.nonzero(act[sel] & (cnt[sel // BLOCK_R] > 0))[:, 0]
    n_of = cnt[sel[pos] // BLOCK_R]
    order = torch.argsort(n_of, stable=True)
    pos, n_of = pos[order], n_of[order].cpu().numpy()
    lim = max(1, _SLAB_ELEMS // block_m)
    i0 = 0
    while i0 < pos.shape[0]:
        # the longest slab whose lanes x (its longest list) stays in bounds
        # (n_of is ascending, so the bound holds for every shorter prefix)
        win = n_of[i0:i0 + lim]
        n_s = int(np.searchsorted(win * np.arange(1, win.shape[0] + 1), lim,
                                  side="right"))
        i1 = i0 + max(1, n_s)
        p = pos[i0:i1]
        lane = sel[p]
        blk = lane // BLOCK_R
        kmax = int(n_of[i1 - 1])
        tiles = lst[blk, :kmax]                                  # [s,k]
        keep = (torch.arange(kmax, device=dev)[None, :] < cnt[blk][:, None])
        ids = (tiles[:, :, None] * block_m
               + torch.arange(block_m, device=dev)).reshape(len(p), -1)
        t = _mt_slab(tab[ids], origin[lane], direction[lane])
        t = torch.where(keep.repeat_interleave(block_m, dim=1), t, _MAX)
        tmin, j = torch.min(t, dim=1)
        t_out[p] = tmin
        idx_out[p] = torch.where(tmin < _MAX, ids.gather(1, j[:, None])[:, 0],
                                 0).to(torch.int32)
        i0 = i1
    return Hit(t=t_out, idx=idx_out)


def tri_nearest_hit_stream(tab, boxes, origin, direction, alive=None, *,
                           stats=None, lists_only: bool = False) -> Hit:
    """K10 (``csrc/tri_stream.cu``): ``tri_stream_plain``'s contract in one
    launch, one thread per lane; each 256-lane block builds its list of
    reachable tiles from its alive lanes in the launch and folds them
    front to back, each lane stopping where its best hit lies before a
    tile's box. The JAX ``nearest_hit_tri_stream``, the triangle search of
    every route past ``resident_tables_fit``. Dead lanes return a miss.
    Neither output carries autograd history. CPU tensors take
    ``tri_stream_plain``.

    For measurement, on CUDA tensors only: stats, an int64 [3] tensor that
    the launch adds its counts to (listed tiles summed over the live
    blocks, live blocks, ray-triangle pairs tested); lists_only builds the
    lists and stops, every lane missing."""
    if not origin.is_cuda:
        if stats is not None or lists_only:
            raise ValueError("stats and lists_only measure the kernel")
        return tri_stream_plain(tab, boxes, origin, direction, alive)
    m, r, n_t = tab.shape[0], origin.shape[0], boxes.shape[0]
    dev = origin.device
    build.require(tab, "tri", torch.float32, (m, 9), dev)
    build.require(boxes, "boxes", torch.float32, (n_t, 6), dev)
    build.require(origin, "origin", torch.float32, (r, 3), dev)
    build.require(direction, "direction", torch.float32, (r, 3), dev)
    if alive is not None:
        build.require(alive, "alive", torch.bool, (r,), dev)
    if stats is not None:
        build.require(stats, "stats", torch.int64, (3,), dev)
    if n_t < 1 or m % n_t:
        raise ValueError(f"{m} triangles in {n_t} tiles")
    t = torch.empty(r, dtype=torch.float32, device=dev)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.trt_tri_stream(
            tab.data_ptr(), m, boxes.data_ptr(), n_t, origin.data_ptr(),
            direction.data_ptr(), None if alive is None else alive.data_ptr(),
            r, t.data_ptr(), idx.data_ptr(), int(bool(lists_only)),
            None if stats is None else stats.data_ptr(),
            build.stream_of(origin))
    build.check("trt_tri_stream", err)
    tri_nearest_hit_stream.launches += 1
    return Hit(t=t, idx=idx)


tri_nearest_hit_stream.launches = 0
