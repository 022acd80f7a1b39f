#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from tpu_ray_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card (K1, the sphere
search, bit for bit in the slices it picks and in 1, 2 and 7, two launches
bit-equal, on random rays, rtweekend's, trimesh's and sixteen's primary
rays and bigmesh's primary and sorted bounce-1 states), renders with K1
(held against the same render with the plain search; K1's device time
over the pass and its time a launch, as on every path that launches it:
trimesh on backend cuda, bigmesh's pass and step, the sixteen and
trilight estimators' backward), then drives the main path as the CLI
does: rtweekend at 1920x1080, 64 spp,
backend fused + regen, through K2's culled sphere search. The main path's
own regen state is then run through the kernel again, which must give the
main path's image, and every 32nd lane of it is held bit for bit against
the plain version over all 320 steps, its counters (boxes, tiles and
pairs tested) against the plain mirror's; the sweep of every sphere is
timed in turns with it, and the sphere tiles' host cost. Then the forward+backward main path, as a user
differentiates it:
image_mse(grad.render_mean(...), 0).backward() w.r.t. every scene leaf and
the camera, three calls, through K2's recording mode and the K3 backward;
K2-record is held against the forward-only K2 and (1 lane in 32) its plain
version, K3 at the main path's own records against its plain version on
1 lane in 32, with its registers, occupancy and lane-steps; the fused
gradients against backend torch
autograd at 320x180; two make_train_step steps at full size. Then the
per-sample fused route (backend fused without regen) at the same size:
K4, K5 and K6 at
the route's own inputs (the main camera's sample 0, 1 lane in 32, and K6
also on all lanes) against their plain versions (K4 culled by the Morton
sphere tiles as the route runs it, by the host masks and not at all, its
counters against the plain mirror's), a forward pass as the CLI drives
it (which must give the regen route's image bit for bit), K4 over the
pass's own states with its counters (boxes, tiles and pairs tested) and
on 1 lane in 32 of every bounce against its plain version, the pass's K4
launches culled and with the host mask it replaced timed in turns, three
forward+backward steps as a user differentiates it, one more of each
under torch.profiler for the kernels' device times and the device's idle
share (the kernels' bounds are counted from the same samples outside
those calls), and the route's gradients against the regen route's at
320x180. Then the triangle
scenes: K7 (the triangle search of backend cuda) against its plain version
on trimesh's primary rays (320x180 on every lane, 1920x1080 on 1 lane in
32, its time and the triangle slices it chose at both) and backend cuda's
trimesh render against backend torch's; the triangle main path, trimesh
(10,242 triangles) at 1920x1080, 2 spp on fused + regen as the CLI
drives it (two calls, through K2's listed triangle mode; at the path's
own state, every 32nd 256-lane block bit for bit against the listed
plain version over all
steps, the regen list pass rate and the pairs tested from the kernel's
counters; the sweep of every triangle, as a caller names it: its image
within 20 pixels of the listed route's, 1 lane in 32 bit for bit against
its plain version), forward and backward as a user differentiates it
(three calls; K2-record's listed mode on every 32nd block against its
plain version, state and records, and K3's triangle branch at the path's
own records against its plain version on 1 lane in 32, two K3 launches
bit-equal, the global-row merge's counts: rows a block touched, partial
bytes written and read, one merge a step), and its gradients (and the per-sample route's) against
backend cuda autograd at 320x180. Then the per-sample route on trimesh
at 1920x1080, 2 spp: K8 (bounce_fwd_list) and the triangle modes of K5
and K6 at the route's own inputs (sample 0: K8 on every 32nd 256-lane
block of every bounce's state against its plain version and the whole
launch, with its counters, K5 and K6 on 1 lane in 32, K6 also on all
lanes, two K6 launches bit-equal, K6's d_table on the slice bit for bit
the fixed order over the plain version's lane terms
(table_sum_fixed_order) with the same counts, the global-row merge's
counts at full width), the forward pass as the CLI drives it
(two calls; its image against the regen route's, the differing pixels
counted), the list pass rate and K8's bounds (over the pairs its
counters say it tested, the listed pairs and every triangle) counted on
the pass's own states, three forward+backward steps, and one pass and
one step under torch.profiler; and the same pass with tri_list=False
(make_fused_sample's sweep of every triangle, K4's triangle mode): two
calls and a profiled one, its image within 20 pixels of the listed
route's, K4's triangle mode on 1 lane in 32 of sample 0 against its
plain version, its bound over the pairs an exact culled search tests on
those rays (K8's counters on the same states) and over every triangle.
Then the flat and Lambert+shadow estimators on the fused route (K9,
csrc/simple_shade.cu: its spheres folded over their Morton tiles, its
triangles over primary and shadow block lists folded front to back), each
configuration at its own size, its counters held to the plain version's
and its bound over what it tested beside the bound over the listed pairs:
BASELINE.md config 2 (sixteen, Lambert, 512x512, 4 spp: K9 bit-equal to
its plain version on all lanes, two passes as the CLI drives them, three
forward+backward steps
whose gradients must match backend cuda autograd), config 1 (single,
flat, 256x256, 1 spp: K9 on all lanes, the image equal to backend
cuda's), trimesh flat at 1920x1080, 4 spp (K9 on 1 lane in 32 and on
every 32nd 256-lane block, the sweep of every tile timed, the image
against backend cuda's at 320x180) and trilight (Lambert over triangles,
1920x1080, 4 spp: K9 on every 32nd 256-lane block, the shadow winners of
its lists against the sweep of every tile, gradients against backend cuda
autograd at 320x180), and one profiled pass of each. Then the route past
the residency rule: bigmesh (163,842 triangles in 1,281 tiles) at 1920x1080,
1 spp. K10 (csrc/tri_stream.cu, the listed triangle search) at the pass's
own primary rays and sorted bounce-1 state, bit for bit against its plain
version on 1 lane in 32 and against K7 on every alive lane (differing
lanes counted; none where K7's hit lies inside its tile's box; K7's time,
slices and bound there recorded), and its
bound counted on every bounce's state, beside each bounce's time, the
time of a launch that only builds the lists, and the pairs tested
against the pairs listed (the kernel's counters, its lists held to the
plain version's); K11 (csrc/gather_rows.cu, the payload gathers'
backward) at the sphere and triangle winners of the primary rays and of
bounce 1, and with all lanes on row 0 of the triangle table, bit for bit
against its plain version, two launches bit-equal, rows no lane gathers
+0.0, its time beside autograd of table[idx] and index_add_; the pass as
the CLI drives it on
backend fused, which falls back to the probe route (two calls, one more
under torch.profiler, its image equal to backend cuda's, and one call at
ray_chunk=43200); three forward+backward steps with remat="save_hits"
(no search in the backward, K11 there; gradients against remat=False's;
K11's device time in a profiled step) and one
with remat="save_hits_bounce" (each bounce recomputed on its own from the
saved hits: no search in the backward, its gradients within rtol 1e-4 /
atol 1e-7 + 1e-5 x max of the "save_hits" step's, both steps' wall time
and peak memory printed); and the fused flat estimator's warning and
fallback. Then the CLI's progressive surface on the main path's
configuration (rtweekend 1920x1080, fused + regen), through
tpu_ray_torch.cli.main as a user runs it: render at 64 spp, two passes
with --metrics and --profile, against one pass with --checkpoint and
then --resume for one more (the accumulated means bit-equal, the rays
equal, a metrics line a pass, K2's kernel named in the trace); animate,
3 frames at 4 spp, each frame equal to a PathTracer.step at its orbit
camera; and sharding on a 1-rank nccl group with a mesh of 1:
render_pass_sharded at 64 spp bit-equal to render_pass, and
render_mean_sharded forward+backward (K2-record and K3) within 3e-3 of
each group's max of one process's gradients. Then the eight library
examples (tpu_ray_torch/examples), each main() at its defaults as a user
runs it: a first call under torch.profiler whose trace must name the
kernels of its route (K4 on 1-4, K5 and K6 on 3-4, K1 on 5, K8 on 6, K9
on 7, K1, K10 and K11 on 8), then a counted call with its wall seconds, rays
cast and peak memory; example 2's fused image equal to backend cuda's,
3's fused gradients within 3e-3 of each group's max of backend cuda
autograd, 4's albedo error falling, 5 with --mesh 1 on the 1-rank nccl
group bit-equal to render_pass, 6's fused image within 20 pixels of
backend cuda's (past rtol 1e-5 / atol 1e-6), 8 with --grad past the
residency rule (finite gradients, a nonzero vertex norm).
Prints each phase's wall seconds, a
JSON line of main-path numbers, one JSON line of per-kernel numbers and,
last, one JSON line with the device. Any failed check raises, so the exit
code is nonzero; without a CUDA device, or without the tpu_ray_torch
package beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_F32 = 67e12          # flop/s
PEAK_BYTES = 3.35e12      # bytes/s
# one ray-sphere test of csrc/common.cuh trt_nearest_sphere: 3 sub (m),
# 5 (t_proj), 6 (projection), 5 (dsq), 1 (r^2)
FLOPS_PER_PAIR = 20
# one slab test of a sphere tile's box in csrc/common.cuh trt_box_entry:
# 3 x (2 sub, 2 mul) and the min/max of the interval's ends
FLOPS_PER_BOX = 20
# one ray-triangle test of csrc/common.cuh trt_tri_hit, by the stage at
# which the pair leaves it: 9 (pvec) + 5 (det) for a pair that fails the
# det test; + 1 (1/det) + 3 (tvec) + 6 (u) for one that fails the u test;
# + 9 (qvec) + 6 (v) + 6 (t) + 1 (u + v) for one that goes through
MT_FLOPS_DET, MT_FLOPS_U, MT_FLOPS_WHOLE = 14, 24, 46
TRI_BYTES = 36            # v0, e1, e2 of one triangle in the search table
STATE_BYTES = 24 * 4      # one lane of the regen state
SPHERE_BYTES = 48         # center, radius, albedo, emissive, specular, ior

SEED = 0
PROFILE_MARGIN = 0.02
CHECK_W, CHECK_H, CHECK_SPP = 320, 180, 4
MAIN_W, MAIN_H, MAIN_SPP, MAX_BOUNCES = 1920, 1080, 64, 5
# the triangle main path: BASELINE.md config 4 and its gradient row
TRI_SPP = 2
SLICE_STRIDE = 32         # plain K2 runs on every 32nd lane of the main state
# fp32 operations of one alive lane-step of K3, counted from
# csrc/regen_step.cuh trt_step_tail (replay, ~107 on a diffuse hit) and
# csrc/regen_bwd.cu (shade_vjp's primal recompute ~139 and transpose ~237,
# the regenerated ray's camera transpose ~73), rounded down
K3_FLOPS_PER_STEP = 550
BOUNCE_STATE_BYTES = 16 * 4   # one lane of the per-sample state
# the bytes a lane of K6 must move: state rows 0-8, 12 and 13 read, the
# cotangent's rows 0-11 read, d_state rows 0-8 and 12-15 written in place
# (rows 9-11 pass through untouched), the 4 B winner id read
K6_LANE_BYTES = (11 + 12 + 13) * 4 + 4
# fp32 operations of a live lane in K5 (csrc/shade.cuh trt_shade, ~107 on
# a diffuse hit) and K6 (trt_shade_vjp's primal recompute ~139 and
# transpose ~237), rounded down
K5_FLOPS_PER_LANE = 100
K6_FLOPS_PER_LANE = 370


# the estimators' configurations, each at its own size (scene, shading,
# width, height, spp): BASELINE.md configs 2 and 1, its trimesh flat row,
# and the JAX suite's mixed sphere + triangle scene for triangle shadows
EST_CONFIG2 = ("sixteen", "lambert_shadow", 512, 512, 4)
EST_CONFIG1 = ("single", "flat", 256, 256, 1)
EST_TRIMESH = ("trimesh", "flat", 1920, 1080, 4)
EST_TRILIGHT = ("trilight", "lambert_shadow", 1920, 1080, 4)
# K9's bytes a lane: rows in (x, y, h1), colour sum and rays out
K9_LANE_BYTES = 12 + 16
# the route past the residency rule: bigmesh at BASELINE.md's size (its
# forward and forward+backward rows), bench.py's ray chunk for it, and the
# flat estimator's fallback at the check size
BIG = ("bigmesh", 1920, 1080, 1)
BIG_CHUNK = 43200
BIG_EST = (CHECK_W, CHECK_H)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def timed(torch, fn):
    """(fn(), device milliseconds of that one call), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    fn()
    return timed(torch, lambda: [fn() for _ in range(reps)])[1] / reps


def queued_ms(torch, fn, calls: int) -> float:
    """Mean device milliseconds of fn() over calls calls queued behind a
    spin of the device (torch.cuda._sleep, ~0.13 ms of cycles a call), so
    that the host's cost of each call does not pace launches shorter than
    it; after a warm-up. The gaps between the launches are counted."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(250_000 * calls)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def bound(flops: float, nbytes: float):
    """Least time of the work: the larger of its fp32 operations over the
    fp32 peak and its bytes over the memory rate -> (ms, bound_by)."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def mt_work(torch, tab, origin, direction, tiles=None):
    """fp32 operations trt_tri_hit must spend on every pair of these rays
    [R,3] and the triangles of nonzero size in the search table tab [M,9],
    each pair charged by the stage at which it leaves the test ->
    (flops, {stage: share of the pairs}). tiles: optional [R,T] bool, the
    tiles of M/T triangles each ray's list keeps (the others' pairs are
    not tested and not counted). Repeats the op order of
    ops/intersect_tri.py _mt_slab, so each pair leaves where the kernel's
    does."""
    is_real = (tab[:, 3:9] != 0).any(dim=1)
    real = tab[is_real]
    if tiles is not None:
        tile_of = torch.nonzero(is_real)[:, 0] // (tab.shape[0]
                                                    // tiles.shape[1])
    v0x, v0y, v0z = (real[None, :, k] for k in range(3))
    e1x, e1y, e1z = (real[None, :, k] for k in range(3, 6))
    e2x, e2y, e2z = (real[None, :, k] for k in range(6, 9))
    n_ok = n_whole = pairs = 0
    step = max(1, (1 << 23) // max(real.shape[0], 1))
    for k in range(0, origin.shape[0], step):
        ox, oy, oz = (origin[k:k + step, j:j + 1] for j in range(3))
        dx, dy, dz = (direction[k:k + step, j:j + 1] for j in range(3))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) > 1e-9
        inv = torch.ones_like(det) / torch.where(ok, det, 1.0)
        u = ((ox - v0x) * px + (oy - v0y) * py + (oz - v0z) * pz) * inv
        whole = ok & (u >= 0.0)
        if tiles is None:
            pairs += ok.numel()
        else:
            keep = tiles[k:k + step][:, tile_of]
            pairs += int(keep.sum())
            ok, whole = ok & keep, whole & keep
        n_ok += int(ok.sum())
        n_whole += int(whole.sum())
    flops = ((pairs - n_ok) * MT_FLOPS_DET + (n_ok - n_whole) * MT_FLOPS_U
             + n_whole * MT_FLOPS_WHOLE)
    shares = dict(det=(pairs - n_ok) / pairs, u=(n_ok - n_whole) / pairs,
                  whole=n_whole / pairs) if pairs else {}
    return flops, shares


def pair_flops(shares) -> float:
    """Mean fp32 operations of a ray-triangle pair with mt_work's exit
    mix ({stage: share of the pairs})."""
    return (MT_FLOPS_DET * shares.get("det", 0.0)
            + MT_FLOPS_U * shares.get("u", 0.0)
            + MT_FLOPS_WHOLE * shares.get("whole", 0.0))


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# K1's CUDA kernels as torch.profiler names them: the search and, in a
# launch split into slices, its unpack (common.cuh trt_keys_unpack<1>)
K1_NAMES = ("sphere_nearest_hit_kernel", "trt_unpack_keys_kernel<1>")


def k1_held(torch, center, radius, o, d, what: str):
    """K1 on these rays bit for bit against its plain version in the
    slices it picks and in 1, 2 and 7, and two launches bit-equal (the
    launches not counted) -> (the plain version's Hit, K1's slices)."""
    from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                        sphere_nearest_hit,
                                                        sphere_slices)
    want = nearest_hit_plain(center, radius, o, d)
    before = sphere_nearest_hit.launches
    for slices in (None, 1, 2, 7):
        a = sphere_nearest_hit(center, radius, o, d, slices=slices)
        b = sphere_nearest_hit(center, radius, o, d, slices=slices)
        torch.cuda.synchronize()
        require(torch.equal(a.idx, want.idx)
                and bits_equal(torch, a.t, want.t),
                f"K1 ({what}, slices {slices}): differs from plain")
        require(torch.equal(a.idx, b.idx) and bits_equal(torch, a.t, b.t),
                f"K1 ({what}, slices {slices}): two launches differ")
    sphere_nearest_hit.launches = before
    return want, sphere_slices(o.shape[0], center.shape[0], o.device)


def k1_path(torch, center, radius, o, d, launches: int, ms: float,
            shape: str, **extra) -> dict:
    """K1's record on one path whose launches each search r = len(o)
    rays over center/radius: its device time there (ms, torch.profiler
    over the pass or step), its time a launch on the rays o, d (CUDA
    events, queued_ms: the memset and the unpack of a split launch
    included, ms_launch), its slices, and its bound: each launch's fp32
    operations over the slots with r * r > 0 (the slots it folds) and its
    bytes (the rays in, t and idx out, every radius and the real slots'
    centres read once), times its launches."""
    from tpu_ray_torch.kernels.sphere_intersect import (sphere_nearest_hit,
                                                        sphere_slices)
    r, n = o.shape[0], center.shape[0]
    c = int((radius * radius > 0).sum())
    before = sphere_nearest_hit.launches
    ms_launch = queued_ms(torch, lambda: sphere_nearest_hit(center, radius,
                                                            o, d), 20)
    sphere_nearest_hit.launches = before
    b = bound(launches * r * c * FLOPS_PER_PAIR,
              launches * (r * 32 + n * 4 + c * 12))
    return dict(shape=shape, rays_per_launch=r, slots=n, real_slots=c,
                slices=sphere_slices(r, n, o.device), launches=launches,
                ms=ms, ms_launch=ms_launch, bound_ms=b[0], bound_by=b[1],
                **extra)


# K11, the payload gathers' backward (kernels/gather_rows.gather_rows_bwd):
# its counted key, its CUDA kernels as torch.profiler names them (the
# stable sort before them is PyTorch's, named by CUB), and the bytes a
# lane of its stable order moves besides its g row and idx: an int32 key
# and an int64 lane id, each written once and read once. These belong to
# this design's ordering, not to the function, so they stay out of its
# bound and are reported beside it.
K11 = "gather_rows_bwd"
K11_NAMES = ("gather_rows_down_kernel", "gather_rows_up_kernel")
K11_ORDER_BYTES = 2 * (4 + 8)


def searches(launched: dict) -> dict:
    """The launches of the search and render kernels: launched without
    K11's."""
    return {k: v for k, v in launched.items() if k != K11}


def k11_held(torch, idx, n: int, w: int, what: str, gen) -> dict:
    """K11 on idx [R] int32 into an [n, w] table, its cotangent g [R, w]
    drawn from gen: bit for bit its plain version on the card, two
    launches bit-equal, rows no lane gathers +0.0 (the launches not
    counted); its device ms (CUDA events, the stable sort included; the
    sort alone beside it), the plain version's, and the two PyTorch calls
    that compute the same function: autograd of table[idx] (IndexBackward0,
    index_put_ with accumulate, the port's path before K11) and index_add_
    into zeros (float atomics), with how far each lies from K11 in units
    of the entry's sum of |g| (each within 1e-6 of it, or the smoke
    fails: a witness independent of K11's ordering) and whether two of its
    calls agree bit for bit; the bound by the function's bytes (each lane's
    idx and g row read once, d_table written once), and beside it the
    bytes of the order's key and lane id, written and read once."""
    from tpu_ray_torch.kernels.gather_rows import (gather_rows_bwd,
                                                   gather_rows_bwd_plain)
    r, dev = idx.shape[0], idx.device
    g = torch.randn((r, w), generator=gen, device=dev)
    before = gather_rows_bwd.launches
    a = gather_rows_bwd(idx, g, n)
    b = gather_rows_bwd(idx, g, n)
    p = gather_rows_bwd_plain(idx, g, n)
    torch.cuda.synchronize()
    require(bits_equal(torch, a, p), f"K11 ({what}): differs from plain "
            f"by max {(a - p).abs().max().item()}")
    require(bits_equal(torch, a, b), f"K11 ({what}): two launches differ")
    rows_hit = torch.bincount(idx.long(), minlength=n) > 0
    require(not bool(a[~rows_hit].view(torch.int32).any()),
            f"K11 ({what}): a row no lane gathers is not +0.0")
    ms = cuda_ms(torch, lambda: gather_rows_bwd(idx, g, n), 10)
    sort_ms = cuda_ms(torch, lambda: torch.sort(idx, stable=True), 10)
    plain_ms = cuda_ms(torch, lambda: gather_rows_bwd_plain(idx, g, n), 2)
    gather_rows_bwd.launches = before
    leaf = torch.zeros((n, w), device=dev, requires_grad=True)
    out = leaf[idx.long()]

    def autograd():
        return torch.autograd.grad(out, leaf, g, retain_graph=True)[0]

    def index_add():
        return torch.zeros((n, w), device=dev).index_add_(0, idx, g)

    abs_sum = torch.zeros((n, w), dtype=torch.float64, device=dev).index_add_(
        0, idx, g.abs().double())
    lib = {}
    for key, fn in (("autograd", autograd), ("index_add", index_add)):
        x, y = fn(), fn()
        lib[key] = dict(
            ms=cuda_ms(torch, fn, 2),
            max_err_in_abs_sums=((x.double() - a.double()).abs()
                                 / abs_sum.clamp_min(1e-30)).max().item(),
            two_calls_bit_equal=bits_equal(torch, x, y))
        require(lib[key]["max_err_in_abs_sums"] <= 1e-6,
                f"K11 ({what}): {key} lies {lib[key]['max_err_in_abs_sums']}"
                f" of an entry's sum of |g| from K11, more than 1e-6")
    del out, leaf
    b_ms, b_by = bound(0.0, r * (w + 1) * 4 + n * w * 4)
    order_bytes = r * K11_ORDER_BYTES
    rec = dict(lanes=r, rows=n, width=w, rows_gathered=int(rows_hit.sum()),
               row0_lanes=int((idx == 0).sum()), ms=ms, sort_ms=sort_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               order_bytes=order_bytes,
               order_ms=bound(0.0, order_bytes)[0],
               autograd_ms=lib["autograd"]["ms"],
               index_add_ms=lib["index_add"]["ms"], library=lib)
    print(f"K11 check, {what}: {r} lanes into [{n},{w}] ({rec['row0_lanes']} "
          f"on row 0, {rec['rows_gathered']} rows gathered): bit-equal to "
          f"plain, two launches bit-equal, rows no lane gathers +0.0; K11 "
          f"{ms:.4f} ms (the sort {sort_ms:.4f} of it; CUDA events), bound "
          f"{b_ms:.4f} ms by {b_by} (the order's {order_bytes} bytes "
          f"{rec['order_ms']:.4f} ms more), plain {plain_ms:.3f} ms; autograd of "
          f"table[idx] {lib['autograd']['ms']:.3f} ms, index_add_ "
          f"{lib['index_add']['ms']:.4f} ms; {lib}", flush=True)
    return rec


# the CUDA kernels of each bounce wrapper, as torch.profiler names them
# (K6 is two launches: the per-block partials, then their fixed-order sum,
# csrc/shade.cuh trt_sum_parts or trt_sum_parts_touched)
BOUNCE_KERNELS = {"bounce_fwd": ("bounce_fwd_kernel",),
                  "bounce_fwd_list": ("bounce_fwd_list_kernel",),
                  "bounce_replay": ("bounce_replay_kernel",),
                  "bounce_bwd": ("bounce_bwd_kernel", "trt_sum_parts")}


def merge_record(stats, parts: int, n: int, launches: int) -> dict:
    """The records of the global-row merge of K3 or K6 from its counts
    (csrc/shade.cuh trt_row_merge_end, summed over launches of parts
    blocks each on a table of n rows): rows a block touched (mean and
    max), partial bytes a launch written and read (48 B a row entry: each
    merge's read-add-write, a first touch writing only, the sum launch
    reading each touched entry once; the bitmaps, 4 B a 32 rows a block,
    written once and read once), warp sums and row entries written a
    merged step; beside them the bytes the turns' scheme zeroed and summed
    a launch (every block's whole row)."""
    merges, sums, writes, firsts, most = stats.tolist()
    bitmaps = 4 * -(-n // 32) * parts
    return dict(merges=merges, rows_touched_per_block_mean=firsts / (
        parts * launches), rows_touched_per_block_max=most,
        partial_bytes_written_per_launch=48 * writes / launches + bitmaps,
        partial_bytes_read_per_launch=48 * writes / launches + bitmaps,
        warp_sums_per_merge=sums / max(merges, 1),
        row_writes_per_merge=writes / max(merges, 1),
        turns_bytes_zeroed_and_summed_per_launch=2 * 48 * n * parts)


def profiled(torch, fn):
    """(fn(), wall s, {kernel key: device ms}, device busy ms) of one call
    under torch.profiler, which reads each kernel's time on the card. The
    trace opens and closes PROFILE_MARGIN s away from the call (outside
    the wall time), a precaution: once a 2 ms pass's K9 launch, counted
    by its wrapper, was missing from the trace, and that did not recur."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_MARGIN)
    by_key = {e.key: e.self_device_time_total / 1e3
              for e in prof.key_averages()}
    return out, wall, by_key, sum(by_key.values())


def kernel_ms(by_key, names) -> float:
    """Device ms of the profiled kernels whose name contains one of names."""
    return sum(ms for key, ms in by_key.items()
               if any(n in key for n in names))


def estimator_phases(torch, dev, card, reset_counts, counts, k1_paths):
    """Phases 25-29: the flat and Lambert+shadow estimators on the fused
    route (K9, kernels/simple_shade.py) at the estimator configurations'
    own sizes; K1 in sixteen's and trilight's backward (the eager
    estimator), recorded in k1_paths. -> ({kernel key: entry},
    {configuration: numbers})."""
    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import (make_scene, make_trilight_scene,
                                          trainable_scene)
    from tpu_ray_torch.grad import image_mse
    from tpu_ray_torch.kernels.regen import cam13
    from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, TRI_BLOCK_M,
                                                   init_state, nearest_prim,
                                                   origin_bound)
    from tpu_ray_torch.kernels.simple_shade import (N_STATS, lane_rows,
                                                    simple_tables,
                                                    simple_trace,
                                                    simple_trace_plain)
    from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri
    from tpu_ray_torch.models.path_tracer import (render_pass,
                                                  render_pixels, tile_order,
                                                  untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.ops.shading_modes import scene_light_indices

    kernels, summary = {}, {}
    k9_names = ("simple_trace_kernel",)

    def setup(cfg):
        """The scene and K9's inputs of cfg's pass (tile-ordered lanes,
        samples 0 .. spp - 1), as the route builds them."""
        name, shading, w, h, spp = cfg
        sc = (make_trilight_scene(device=dev) if name == "trilight"
              else make_scene(name, device=dev))
        lights = scene_light_indices(sc) if shading != "flat" else ()
        cam = default_camera(sc)
        tb = simple_tables(sc, lights, origin_bound(cam.position[None]))
        perm, inv = tile_order(w, h)
        px = torch.as_tensor(perm, device=dev)
        args = (lane_rows(px, w, SEED), cam13(cam, spp),
                tb["table"], tb["tri"], tb["boxes"], tb["lidx"], tb["ldat"])
        kw = dict(n_sph=tb["n_sph"], spp=spp, s0=0, width=w, height=h,
                  use_sky=tb["use_sky"], flat=shading == "flat",
                  sph=tb["sph"])
        return sc, lights, args, kw, inv

    def drive(cfg, sc, calls):
        """render as the CLI drives it (PathTracer.step of one pass),
        counts set to 0 before each call -> (tracer, state, rays, secs)."""
        name, shading, w, h, spp = cfg
        tracer = PathTracer(RenderConfig(
            scene=name, width=w, height=h, spp=spp, backend="fused",
            seed=SEED, shading=shading), scene=sc, device=dev)
        secs = []
        for _ in range(calls):
            state0 = tracer.init_state()
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            state, rays = tracer.step(state0)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            require(counts()["simple_trace"] == 1
                    and sum(counts().values()) == 1,
                    f"{name} {shading} pass launched {counts()}")
        require(tuple(state.mean.shape) == (h, w, 3)
                and bool(torch.isfinite(state.mean).all())
                and state.mean.mean().item() > 0.01,
                f"{name} {shading} image is not finite and non-black")
        return tracer, state, rays, secs

    def work(args, kw, n_real_sph, lanes=None, r_full=None, stats=None):
        """(fp32 operations, bytes) K9 must spend on these inputs over the
        listed pairs, counted on the plain version's own searches of the
        lanes ``lanes`` (all when None) and scaled to r_full lanes (the
        launch's when None): every cast ray tests every real sphere
        (FLOPS_PER_PAIR), and each ray-triangle pair of its listed or swept
        tiles is charged by where it leaves the test (mt_work); the lanes'
        bytes in and out and the tables read once. -> also the plain
        version's output, its searches (``folds``: each sample's primary
        search, then one a light) and the mean operations of a listed real
        pair (0 without triangles). stats: the plain version's counters."""
        folds = []
        out = simple_trace_plain(*args, **kw, lanes=lanes, folds=folds,
                                 stats=stats)
        r = args[0].shape[1] if r_full is None else r_full
        scale = r / out.shape[1]
        flops = float(out[3].double().sum()) * n_real_sph * FLOPS_PER_PAIR
        tri_flops = tri_pairs = 0.0
        if args[3] is not None:
            for o, d, tiles, act in folds:
                f, shares = mt_work(torch, args[3], o[:, act].T, d[:, act].T,
                                    None if tiles is None else tiles[act])
                flops += f
                tri_flops += f
                tri_pairs += f / pair_flops(shares) if shares else 0.0
        nbytes = r * K9_LANE_BYTES + sum(
            t.numel() * 4 for t in args[1:] if t is not None)
        return (flops * scale, nbytes, out, folds,
                tri_flops / tri_pairs if tri_pairs else 0.0)

    def counted(args, kw, per_pair):
        """K9's counters on a launch of args (an int64 [N_STATS] tensor)
        and its bound over what it tested: the triangle pairs its walk
        reached at per_pair operations each (the listed real pairs' exit
        mix), the sphere pairs and sphere boxes at FLOPS_PER_PAIR and
        FLOPS_PER_BOX."""
        st = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
        simple_trace(*args, **kw, stats=st)
        torch.cuda.synchronize()
        c = st.tolist()
        flops = (c[4] * per_pair + c[7] * FLOPS_PER_PAIR
                 + c[5] * FLOPS_PER_BOX)
        nbytes = args[0].shape[1] * K9_LANE_BYTES + sum(
            t.numel() * 4 for t in args[1:] if t is not None)
        return st, bound(flops, nbytes)

    def stats_agree(key, sk, sp):
        """K9's counters equal the plain version's, but the pairs tested
        (index 4), which the front-to-back walk cuts short of every
        listed pair, at most the plain version's."""
        k, p = sk.tolist(), sp.tolist()
        require(k[:4] == p[:4] and k[5:] == p[5:] and k[4] <= p[4],
                f"{key}: K9's counters {k} against the plain version's {p}")

    def block_slice(args, r):
        """args on every 32nd 256-lane block (whole blocks, so each lists
        as in the full launch) -> (lanes, the sliced args)."""
        lanes = (torch.arange(0, -(-r // BLOCK_R), SLICE_STRIDE,
                              device=dev)[:, None] * BLOCK_R
                 + torch.arange(BLOCK_R, device=dev)).flatten()
        lanes = lanes[lanes < r]
        return lanes, (args[0][:, lanes].contiguous(),) + args[1:]

    def grads_of(sc, cam, cfg_g, backend, lights):
        """image_mse(render_pass(...), 0).backward() w.r.t. every scene
        leaf and the camera -> (grads, rays, launches, seconds). Backend
        cuda renders the fused route's tile-ordered pixels (then untiles
        them), so both sum their rays into each leaf in one order and
        differ only by the forward values the loss weighs them with."""
        name, shading, w, h, spp = cfg_g
        tsc, tcam = trainable_scene(sc), trainable_camera(cam)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        kw = dict(width=w, height=h, spp=spp, seed=SEED, backend=backend,
                  shading=shading, lights=lights)
        if backend == "fused":
            img, rays = render_pass(tsc, tcam, **kw)
        else:
            perm, inv = tile_order(w, h)
            color, rays = render_pixels(
                tsc, tcam, torch.as_tensor(perm, device=dev),
                sample_start=0, **kw)
            img = untile_image(color, w, h, inv)
        image_mse(img, torch.zeros_like(img)).backward()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        g = {k: tsc.leaf(k).grad for k in tsc.leaves}
        g.update(position=tcam.position.grad, look_at=tcam.look_at.grad)
        for k, v in g.items():
            require(v is not None and bool(torch.isfinite(v).all()),
                    f"{name} {backend} gradient of {k} missing or not finite")
        return g, rays, counts(), secs

    def grad_err(got, want):
        """each group's max |got - want| over its max |want|"""
        return {k: ((got[k] - want[k]).abs().max()
                    / want[k].abs().max().clamp_min(1e-12)).item()
                for k in want}

    def entry(key, cfg, launches, err, ms, plain_ms, b, bt, b_key,
              **extra):
        """kernels[key]: bound_ms is the smaller of b (the bound over
        every pair the plain version folds, kept as b_key) and bt (over
        what the launch tested, kept as bound_tested_ms)."""
        name, shading, w, h, spp = cfg
        least = min(b, bt, key=lambda x: x[0])
        kernels[key] = dict(
            name=key, route="cuda",
            source="tpu_ray_torch/csrc/simple_shade.cu",
            replaces="tpu_ray/kernels/simple_shade.py:496",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=least[0], bound_by=least[1], library_ms=None,
            path=f"render --scene {name} --backend fused --shading "
                 f"{shading} {w}x{h} {spp} spp", bound_tested_ms=bt[0],
            **{b_key: b[0]}, **extra)

    # 25. BASELINE.md config 2: sixteen, Lambert+shadow (2 lights),
    # 512x512, 4 spp. K9 against its plain version on all 262,144 lanes
    # (colour and rays bit-equal, the counters equal; launches not
    # counted), the pass
    # as the CLI drives it (two calls), three forward+backward steps
    # (image_mse(render_pass(...), 0).backward() w.r.t. every scene leaf
    # and the camera: K9 forward, the eager estimator on K1 backward), the
    # gradients within 1e-5 of each group's max of backend cuda autograd;
    # one more step under torch.profiler for K1's device time, and K1 bit
    # for bit on the primary rays
    t0 = time.perf_counter()
    cfg2 = EST_CONFIG2
    _, _, w2, h2, spp2 = cfg2
    s16, l16, args2, kw2, inv2 = setup(cfg2)
    require(l16 == (1, 2), f"sixteen's lights are {l16}")
    n_real16 = int((s16.radius > 0).sum())
    out_k2 = simple_trace(*args2, **kw2)
    sp2 = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    flops2, bytes2, out_p2, _, _ = work(args2, kw2, n_real16, stats=sp2)
    torch.cuda.synchronize()
    require(bits_equal(torch, out_k2, out_p2),
            f"K9 (sixteen Lambert) differs from plain by max "
            f"{(out_k2 - out_p2).abs().max().item()}")
    sk2, bt2 = counted(args2, kw2, 0.0)
    stats_agree("sixteen", sk2, sp2)
    k9_ev2 = cuda_ms(torch, lambda: simple_trace(*args2, **kw2), 10)
    plain2 = cuda_ms(torch, lambda: simple_trace_plain(*args2, **kw2), 2)
    b2 = bound(flops2, bytes2)
    tracer2, st2, rays2, secs2 = drive(cfg2, s16, 2)
    launches2 = counts()["simple_trace"]
    require(rays2 == int(out_k2[3].double().sum()),
            f"config 2 pass cast {rays2} rays, K9 {out_k2[3].sum()}")
    require(torch.equal(st2.mean, accumulate(
        tracer2.init_state(), untile_image(out_k2[0:3].T, w2, h2, inv2),
        spp2).mean), "config 2 pass image is not K9's")
    cam16 = default_camera(s16)
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    step_secs2, step_launches2 = [], None
    for _ in range(3):
        g_f2, rays_g2, step_launches2, t_s = grads_of(s16, cam16, cfg2,
                                                      "fused", l16)
        step_secs2.append(t_s)
    peak2 = torch.cuda.max_memory_allocated() - mem0
    n_probe = spp2 * (1 + len(l16))
    require(step_launches2["simple_trace"] == 1
            and step_launches2["sphere_nearest_hit"] == n_probe
            and sum(searches(step_launches2).values()) == 1 + n_probe
            and step_launches2[K11] > 0,
            f"config 2 fwd+bwd launches {step_launches2}")
    require(rays_g2 == rays2, "config 2 fwd+bwd rays differ from the pass")
    (_, _, launches_q2, _), _, by_key_q2, _ = profiled(
        torch, lambda: grads_of(s16, cam16, cfg2, "fused", l16))
    require(launches_q2 == step_launches2,
            f"the profiled config 2 fwd+bwd step launched {launches_q2}")
    o16, d16, _ = camera_rays(cam16, w2, h2, torch.arange(w2 * h2,
                                                          device=dev), 0,
                              SEED)
    k1_held(torch, s16.center, s16.radius, o16, d16, "sixteen primary rays")
    k1_paths["sixteen, estimator backward"] = k1_path(
        torch, s16.center, s16.radius, o16, d16, n_probe,
        kernel_ms(by_key_q2, K1_NAMES),
        f"fwd+bwd step, sixteen lambert_shadow {w2}x{h2} {spp2} spp on "
        f"fused: {n_probe} launches of {w2 * h2} rays x {s16.n_pad} slots")
    g_c2, rays_c2, _, _ = grads_of(s16, cam16, cfg2, "cuda", l16)
    require(rays_c2 == rays2, f"backend cuda cast {rays_c2} rays, K9 {rays2}")
    err2 = grad_err(g_f2, g_c2)
    require(max(err2.values()) <= 1e-5,
            f"config 2 gradients differ from backend cuda autograd: {err2}")
    for li in l16:
        require(g_f2["center"][li].abs().max().item() > 0
                and g_f2["emissive"][li].abs().max().item() > 0,
                f"light {li} of sixteen takes no gradient")
    print(f"estimator config 2: sixteen lambert_shadow {w2}x{h2} {spp2} spp "
          f"fused: {rays2} rays in {secs2} s = "
          f"{[rays2 / t for t in secs2]} rays/s on {card}; K9 bit-equal to "
          f"plain on all lanes, counters {sk2.tolist()} equal to plain's, "
          f"{k9_ev2:.4f} ms by CUDA events (bound {b2[0]:.4f} ms by {b2[1]} "
          f"over every real sphere, {bt2[0]:.4f} ms by {bt2[1]} over what it "
          f"tested) / plain {plain2:.3f} ms; fwd+bwd steps {step_secs2} s, "
          f"launches "
          f"{step_launches2}, peak {peak2} B above {mem0} B; gradients "
          f"against backend cuda autograd within {max(err2.values()):.3e} "
          f"of each group's max", flush=True)
    phase("est_config2", t0)

    # 26. BASELINE.md config 1: single, flat, 256x256, 1 spp. K9 against
    # its plain version on all lanes (output and counters), the pass as the
    # CLI drives it, and its image against backend cuda's (K1 in the eager
    # estimator), rays equal
    t0 = time.perf_counter()
    cfg1 = EST_CONFIG1
    _, _, w1, h1, spp1 = cfg1
    s1, _, args1, kw1, inv1 = setup(cfg1)
    out_k1 = simple_trace(*args1, **kw1)
    sp1 = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    flops1, bytes1, out_p1, _, _ = work(args1, kw1,
                                        int((s1.radius > 0).sum()), stats=sp1)
    torch.cuda.synchronize()
    require(bits_equal(torch, out_k1, out_p1),
            "K9 (single flat) differs from plain")
    sk1, bt1 = counted(args1, kw1, 0.0)
    stats_agree("single", sk1, sp1)
    k9_ev1 = cuda_ms(torch, lambda: simple_trace(*args1, **kw1), 10)
    plain1 = cuda_ms(torch, lambda: simple_trace_plain(*args1, **kw1), 2)
    b1 = bound(flops1, bytes1)
    tracer1, st1, rays1, secs1 = drive(cfg1, s1, 2)
    launches1 = counts()["simple_trace"]
    require(rays1 == w1 * h1 * spp1, f"config 1 cast {rays1} rays")
    img_c1, rays_c1 = render_pass(s1, default_camera(s1), width=w1,
                                  height=h1, spp=spp1, seed=SEED,
                                  backend="cuda", shading="flat")
    img_f1 = untile_image(out_k1[0:3].T, w1, h1, inv1)
    npx1 = int((img_f1 != img_c1).any(-1).sum())
    require(rays_c1 == rays1 and npx1 == 0,
            f"config 1 image differs from backend cuda's on {npx1} pixels")
    print(f"estimator config 1: single flat {w1}x{h1} {spp1} spp fused: "
          f"{rays1} rays in {secs1} s on {card}; K9 bit-equal to plain, "
          f"counters {sk1.tolist()} equal to plain's, {k9_ev1:.4f} ms "
          f"(bound {b1[0]:.4f} ms by {b1[1]}; {bt1[0]:.4f} ms by {bt1[1]} "
          f"over what it tested) / plain {plain1:.3f} ms; image equal to "
          f"backend cuda's", flush=True)
    phase("est_config1", t0)

    # 27. trimesh flat (BASELINE.md's r5 row): 1920x1080, 4 spp, the block
    # lists on. The pass as the CLI drives it (two calls; rays exactly
    # 4 x 1920 x 1080), K9 against its plain version on 1 lane in 32 (each
    # lane with its full-width block's list), the bound over the listed
    # pairs counted on that slice's own searches, K9's counters on every
    # 32nd 256-lane block's own launch against the plain version's (and
    # that launch's output against the full one's), the whole launch's
    # counters and its bound over what it tested, the image against
    # backend cuda's (K1 + K7) at 320x180, differing pixels counted (the
    # lists' grazing acceptance fuzz)
    t0 = time.perf_counter()
    cfgt = EST_TRIMESH
    _, _, wt, ht, sppt = cfgt
    st_, _, argst, kwt, _ = setup(cfgt)
    tracert, stt, rayst, secst = drive(cfgt, st_, 2)
    launchest = counts()["simple_trace"]
    require(rayst == sppt * wt * ht, f"trimesh flat cast {rayst} rays")
    rt = argst[0].shape[1]
    lanes_t = torch.arange(0, rt, SLICE_STRIDE, device=dev)
    out_kt = simple_trace(*argst, **kwt)
    flopst, bytest, out_pt, foldst, per_pair_t = work(
        argst, kwt, int((st_.radius > 0).sum()), lanes_t)
    torch.cuda.synchronize()
    require(bits_equal(torch, out_kt[:, lanes_t], out_pt),
            "K9 (trimesh flat) differs from plain on 1 lane in 32")
    reach = torch.cat([f[2] for f in foldst]).float().mean().item()
    _, plaint = timed(torch, lambda: simple_trace_plain(*argst, **kwt,
                                                        lanes=lanes_t))
    sub_t, args_tsub = block_slice(argst, rt)
    sp_t = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    out_tsub_p = simple_trace_plain(*args_tsub, **kwt, stats=sp_t)
    sk_tsub = torch.zeros_like(sp_t)
    out_tsub_k = simple_trace(*args_tsub, **kwt, stats=sk_tsub)
    torch.cuda.synchronize()
    require(bits_equal(torch, out_tsub_k, out_tsub_p)
            and bits_equal(torch, out_tsub_k, out_kt[:, sub_t]),
            "K9 (trimesh flat) on every 32nd block differs from plain or "
            "from the full launch")
    stats_agree("trimesh flat, every 32nd block", sk_tsub, sp_t)
    skt, btt = counted(argst, kwt, per_pair_t)
    k9_evt = cuda_ms(torch, lambda: simple_trace(*argst, **kwt), 3)
    bt = bound(flopst, bytest)
    # the same launch with every tile swept (no lists): its time, and the
    # lanes whose output the lists change (a grazing hit outside its
    # tile's box)
    swept = argst[:4] + (None,) + argst[5:]
    out_st = simple_trace(*swept, **kwt)
    k9_swept = cuda_ms(torch, lambda: simple_trace(*swept, **kwt), 1)
    n_lanes_fuzz = int((out_st != out_kt).any(0).sum())
    require(n_lanes_fuzz <= 20, f"K9's lists change {n_lanes_fuzz} lanes of "
            f"trimesh flat against the full sweep")
    kwc = dict(width=CHECK_W, height=CHECK_H, spp=sppt, seed=SEED,
               shading="flat")
    img_ft, rays_ft = render_pass(st_, default_camera(st_), backend="fused",
                                  **kwc)
    img_ct, rays_ct = render_pass(st_, default_camera(st_), backend="cuda",
                                  **kwc)
    npxt = int((img_ft != img_ct).any(-1).sum())
    require(rays_ft == rays_ct and npxt <= 20,
            f"trimesh flat at {CHECK_W}x{CHECK_H} differs from backend cuda"
            f" on {npxt} pixels")
    print(f"estimator trimesh: flat {wt}x{ht} {sppt} spp fused: {rayst} "
          f"rays in {secst} s = {[rayst / t for t in secst]} rays/s on "
          f"{card}; K9 bit-equal to plain on 1 lane in 32 and on every 32nd "
          f"block (counters {sk_tsub.tolist()} against plain's "
          f"{sp_t.tolist()}), {k9_evt:.3f} ms by CUDA events (bound "
          f"{bt[0]:.3f} ms by {bt[1]} over the listed pairs, {btt[0]:.3f} ms "
          f"by {btt[1]} over what it tested; counters {skt.tolist()}; list "
          f"pass rate {reach:.4f}; every tile swept {k9_swept:.3f} ms, "
          f"{n_lanes_fuzz} lanes differ) / plain {plaint:.1f} ms on the "
          f"slice; {CHECK_W}x{CHECK_H} image against backend cuda: {npxt} "
          f"pixels differ", flush=True)
    phase("est_trimesh", t0)

    # 28. trilight (triangle shadows): Lambert+shadow, 1920x1080, 4 spp.
    # The pass as the CLI drives it, K9 against its plain version on every
    # 32nd 256-lane block (whole blocks: a shadow list is its block's) with
    # their own launch's counters, the whole launch's counters and bound
    # over what it tested; the shadow winners of those blocks' lists
    # against the sweep of every tile (a lane may differ only where the
    # sweep's hit lies outside its tile's inflated box), and the lanes
    # whose output the lists change against K9 with every tile swept; and
    # the gradients at 320x180 within 1e-5 of each group's max of backend
    # cuda autograd (the fused backward runs the eager estimator on K1 and
    # K7)
    t0 = time.perf_counter()
    cfgl = EST_TRILIGHT
    _, _, wl, hl, sppl = cfgl
    sl_, ll, argsl, kwl, _ = setup(cfgl)
    require(ll == (0,), f"trilight's lights are {ll}")
    tracerl, stl, raysl, secsl = drive(cfgl, sl_, 1)
    launchesl = counts()["simple_trace"]
    out_kl = simple_trace(*argsl, **kwl)
    rl = argsl[0].shape[1]
    lanes_l, args_lsub = block_slice(argsl, rl)
    sp_l = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    flopsl, bytesl, out_pl, folds_l, per_pair_l = work(
        args_lsub, kwl, int((sl_.radius > 0).sum()), r_full=rl, stats=sp_l)
    sk_lsub = torch.zeros_like(sp_l)
    out_lsub_k = simple_trace(*args_lsub, **kwl, stats=sk_lsub)
    torch.cuda.synchronize()
    require(bits_equal(torch, out_kl[:, lanes_l], out_pl)
            and bits_equal(torch, out_lsub_k, out_pl),
            "K9 (trilight Lambert) differs from plain on every 32nd block")
    stats_agree("trilight, every 32nd block", sk_lsub, sp_l)
    require(raysl == int(out_kl[3].double().sum()), "trilight pass rays")
    _, plainl = timed(torch, lambda: simple_trace_plain(*args_lsub, **kwl))
    skl, btl = counted(argsl, kwl, per_pair_l)
    k9_evl = cuda_ms(torch, lambda: simple_trace(*argsl, **kwl), 3)
    bl = bound(flopsl, bytesl)
    # the shadow folds' winners (each sample's second search) on the
    # block lists against the sweep of every tile
    tab_l, boxes_l, n_sph_l = argsl[2], argsl[4], kwl["n_sph"]
    n_shadow = n_shadow_diff = 0
    for o, d, tiles, act in folds_l[1::2]:
        ray = init_state(o.T, d.T, torch.zeros_like(act, dtype=torch.int64))
        w_list = nearest_prim(ray, tab_l, argsl[3], tiles)
        w_sweep = nearest_prim(ray, tab_l, argsl[3], None)
        th = nearest_hit_tri(argsl[3], o.T, d.T)
        pt_ = o.T + d.T * th.t[:, None]
        bx = boxes_l[(th.idx.long() // TRI_BLOCK_M).clamp(
            max=boxes_l.shape[0] - 1)]
        inside = (w_sweep >= n_sph_l) & ((pt_ >= bx[:, 0:3])
                                         & (pt_ <= bx[:, 3:6])).all(1)
        diff = act & (w_list != w_sweep)
        require(not bool((diff & inside).any()),
                f"trilight: {int((diff & inside).sum())} shadow winners "
                f"differ from the sweep where its hit lies inside its box")
        n_shadow += int(act.sum())
        n_shadow_diff += int(diff.sum())
    swept_l = argsl[:4] + (None,) + argsl[5:]
    out_swl = simple_trace(*swept_l, **kwl)
    k9_swept_l = cuda_ms(torch, lambda: simple_trace(*swept_l, **kwl), 1)
    n_lanes_fuzz_l = int((out_swl != out_kl).any(0).sum())
    require(n_lanes_fuzz_l <= 20, f"K9's lists change {n_lanes_fuzz_l} "
            f"lanes of trilight against the full sweep")
    cfgl_g = ("trilight", "lambert_shadow", CHECK_W, CHECK_H, sppl)
    caml = default_camera(sl_)
    g_fl, rays_gl, launches_gl, _ = grads_of(sl_, caml, cfgl_g, "fused", ll)
    n_probel = sppl * (1 + len(ll))
    require(launches_gl["simple_trace"] == 1
            and launches_gl["sphere_nearest_hit"] == n_probel
            and launches_gl["tri_nearest_hit"] == n_probel
            and launches_gl[K11] > 0,
            f"trilight fwd+bwd launches {launches_gl}")
    (_, _, launches_ql, _), _, by_key_ql, _ = profiled(
        torch, lambda: grads_of(sl_, caml, cfgl_g, "fused", ll))
    require(launches_ql == launches_gl,
            f"the profiled trilight fwd+bwd step launched {launches_ql}")
    ol, dl, _ = camera_rays(caml, CHECK_W, CHECK_H, torch.arange(
        CHECK_W * CHECK_H, device=dev), 0, SEED)
    k1_paths["trilight, estimator backward"] = k1_path(
        torch, sl_.center, sl_.radius, ol, dl, n_probel,
        kernel_ms(by_key_ql, K1_NAMES),
        f"fwd+bwd step, trilight lambert_shadow {CHECK_W}x{CHECK_H} "
        f"{sppl} spp on fused: {n_probel} launches of {CHECK_W * CHECK_H} "
        f"rays x {sl_.n_pad} slots")
    g_cl, rays_cl, _, _ = grads_of(sl_, caml, cfgl_g, "cuda", ll)
    errl = grad_err(g_fl, g_cl)
    require(rays_gl == rays_cl and max(errl.values()) <= 1e-5,
            f"trilight gradients differ from backend cuda autograd: {errl}")
    for k in ("tris.v0", "tris.albedo", "center", "emissive", "position"):
        require(g_fl[k].abs().max().item() > 0,
                f"trilight gradient of {k} is zero")
    print(f"estimator trilight: lambert_shadow {wl}x{hl} {sppl} spp fused: "
          f"{raysl} rays in {secsl} s on {card}; K9 bit-equal to plain on "
          f"every 32nd block (counters {sk_lsub.tolist()} against plain's "
          f"{sp_l.tolist()}), {k9_evl:.3f} ms (bound {bl[0]:.3f} ms by "
          f"{bl[1]} over the listed pairs, {btl[0]:.3f} ms by {btl[1]} over "
          f"what it tested; counters {skl.tolist()}; every tile swept "
          f"{k9_swept_l:.3f} ms, {n_lanes_fuzz_l} lanes differ) / plain "
          f"{plainl:.1f} ms on the slice; shadow winners on the lists "
          f"against the sweep: {n_shadow_diff} of {n_shadow} differ (none "
          f"with the sweep's hit inside its tile's box); {CHECK_W}x{CHECK_H} "
          f"fwd+bwd launches {launches_gl}, gradients against backend cuda "
          f"autograd within {max(errl.values()):.3e} of each group's max",
          flush=True)
    phase("est_trilight", t0)

    # 29. one profiled pass of each configuration: K9's device time
    # (torch.profiler; CUDA events around a launch this short time the
    # host's calls too) and the device's idle share
    t0 = time.perf_counter()
    prof = {}
    for key, tracer, state in (("config2", tracer2, st2),
                               ("config1", tracer1, st1),
                               ("trimesh", tracert, stt),
                               ("trilight", tracerl, stl)):
        before = counts()["simple_trace"]
        (state_p, _), wall, by_key, busy = profiled(
            torch, lambda: tracer.step(tracer.init_state()))
        require(counts()["simple_trace"] - before == 1,
                f"the profiled {key} pass launched K9 "
                f"{counts()['simple_trace'] - before} times")
        require(torch.equal(state_p.mean, state.mean),
                f"the profiled {key} pass image differs")
        ms = kernel_ms(by_key, k9_names)
        require(ms > 0, f"torch.profiler recorded no K9 time ({key})")
        prof[key] = (ms, wall, busy, 1.0 - busy / 1e3 / wall)
        print(f"profiled {key} estimator pass: K9 {ms:.4f} ms, wall "
              f"{wall:.4f} s, device busy {busy:.4f} ms (idle share "
              f"{prof[key][3]:.3f})", flush=True)
    phase("est_profiled", t0)

    entry("simple_trace", cfg2, launches2,
          (out_k2 - out_p2).abs().max().item(), prof["config2"][0], plain2,
          b2, bt2, "bound_every_real_sphere_ms",
          shape=f"{w2 * h2} lanes x {spp2} samples, 2 lights, "
          f"{n_real16} real spheres; ms: torch.profiler, one pass; bound: "
          f"the lesser of what it tested and every real sphere",
          ms_events=k9_ev2, fwd_bwd_launches=step_launches2,
          fwd_bwd_k11_ms=kernel_ms(by_key_q2, K11_NAMES),
          stats=sk2.tolist())
    entry("simple_trace_flat", cfg1, launches1,
          (out_k1 - out_p1).abs().max().item(), prof["config1"][0], plain1,
          b1, bt1, "bound_every_real_sphere_ms",
          shape=f"{w1 * h1} lanes x {spp1} sample; ms: torch.profiler, "
          f"one pass; bound: the lesser of what it tested and every real "
          f"sphere", ms_events=k9_ev1, stats=sk1.tolist())
    entry("simple_trace_tri", cfgt, launchest,
          (out_kt[:, lanes_t] - out_pt).abs().max().item(),
          prof["trimesh"][0], plaint, bt, btt, "bound_listed_pairs_ms",
          shape=f"{rt} lanes x {sppt} samples x {st_.tris.n_real} "
          f"triangles in {argst[4].shape[0]} tiles; ms: torch.profiler, "
          f"one pass; plain: 1 lane in 32; bound: the lesser of what it "
          f"tested and the listed pairs",
          ms_events=k9_evt, list_pass_rate=reach, ms_swept=k9_swept,
          lanes_changed_by_lists=n_lanes_fuzz,
          plain_lanes=int(out_pt.shape[1]), stats=skt.tolist())
    entry("simple_trace_trilight", cfgl, launchesl,
          (out_kl[:, lanes_l] - out_pl).abs().max().item(),
          prof["trilight"][0], plainl, bl, btl, "bound_listed_pairs_ms",
          shape=f"{rl} lanes x {sppl} samples, 1 light, {sl_.tris.n_real} "
          f"triangles; ms: torch.profiler, one pass; plain: every 32nd "
          f"256-lane block; bound: the lesser of what it tested and the "
          f"listed pairs", ms_events=k9_evl,
          plain_lanes=int(out_pl.shape[1]), fwd_bwd_launches=launches_gl,
          fwd_bwd_k11_ms=kernel_ms(by_key_ql, K11_NAMES),
          stats=skl.tolist(), ms_swept=k9_swept_l,
          lanes_changed_by_lists=n_lanes_fuzz_l,
          shadow_winners_differing=n_shadow_diff,
          shadow_searches_checked=n_shadow)
    summary.update(
        config2=dict(width=w2, height=h2, spp=spp2, rays_cast=rays2,
                     seconds=secs2, rays_per_s=[rays2 / t for t in secs2],
                     fwd_bwd_seconds=step_secs2,
                     fwd_bwd_rays_per_s=[rays2 / t for t in step_secs2],
                     fwd_bwd_peak_bytes=peak2, grad_max_rel_err=err2,
                     device_idle_share=prof["config2"][3]),
        config1=dict(width=w1, height=h1, spp=spp1, rays_cast=rays1,
                     seconds=secs1, device_idle_share=prof["config1"][3]),
        trimesh_flat=dict(width=wt, height=ht, spp=sppt, rays_cast=rayst,
                          seconds=secst,
                          rays_per_s=[rayst / t for t in secst],
                          list_pass_rate=reach, k9_swept_ms=k9_swept,
                          pixels_differing_from_cuda=npxt,
                          device_idle_share=prof["trimesh"][3]),
        trilight=dict(width=wl, height=hl, spp=sppl, rays_cast=raysl,
                      seconds=secsl, grad_max_rel_err=errl,
                      shadow_winners_differing=n_shadow_diff,
                      device_idle_share=prof["trilight"][3]))
    return kernels, summary


def bigmesh_phases(torch, dev, card, reset_counts, counts, k1_paths):
    """Phases 30-33: the route past the residency rule on bigmesh (163,842
    triangles, 1,281 tiles of 128) at 1920x1080, 1 spp: K10 (the listed
    triangle search, kernels/tri_intersect.tri_nearest_hit_stream) against
    its plain version and against K7, K1 bit for bit on the same states,
    K11 (kernels/gather_rows.gather_rows_bwd) at the same states' winners,
    the pass as the CLI drives it on backend fused (which falls back to the
    probe route), forward+backward with remat="save_hits" (K11 in the
    backward), and the flat
    estimator's fallback; K1's records of the pass and the step go into
    k1_paths. -> ({kernel key: entry}, numbers)."""
    import warnings
    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import make_scene, trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, TRI_BLOCK_M,
                                                   _block_reach, init_state,
                                                   tri_tile_boxes)
    from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
    from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit,
                                                     tri_nearest_hit_stream,
                                                     tri_slices,
                                                     tri_stream_plain)
    from tpu_ray_torch.models.path_tracer import (past_residency, probe_for,
                                                  render_pixels, tile_order,
                                                  trace_rays, untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays

    name, w, h, spp = BIG
    k10_names = ("tri_stream_kernel",)
    big = make_scene(name, device=dev)
    require(past_residency(big), "bigmesh is within the residency rule")
    cam = default_camera(big)
    tab, boxes = tri_search_table(big.tris), tri_tile_boxes(big.tris)
    n_tiles = boxes.shape[0]
    n_tri_real = big.tris.n_real
    perm, inv = tile_order(w, h)
    pixel = torch.as_tensor(perm, device=dev)
    r = pixel.shape[0]

    # 30. K10 at the main path's own inputs: every bounce's post-sort
    # (origin, direction, alive) of sample 0 on the route's tile-ordered
    # lanes, captured by a probe that records them (the pass's own states:
    # the trace is deterministic). On the primary rays and on bounce 1's
    # state: K10 bit for bit against its plain version on 1 lane in 32
    # (each lane searched over its full-launch block's list), against K7
    # on every alive lane (a lane may differ only where K7's hit lies
    # outside its tile's inflated box, the grazing acceptance fuzz), two
    # launches bit-equal. The bound of the pass is counted on 1 lane in 32
    # of every bounce's state, each pair of its block's listed tiles
    # charged by where it leaves trt_tri_hit (mt_work), and scaled to the
    # state's alive lanes.
    t0 = time.perf_counter()
    states = []
    pf = probe_for(big, "cuda")

    def recording(sc, o, d, alive=None, tape=None):
        states.append((o.clone(), d.clone(), alive.clone()))
        return pf(sc, o, d, alive, tape)

    with torch.no_grad():
        o0, d0, base0 = camera_rays(cam, w, h, pixel, 0, SEED)
        trace_rays(big, o0, d0, base0, MAX_BOUNCES, recording)
    torch.cuda.synchronize()
    require(len(states) >= 2, f"bigmesh traced {len(states)} bounces")
    checks = {}
    k11_inputs = []
    for b in (0, 1):
        o, d, al = states[b]
        hs, k1_sl = k1_held(torch, big.center, big.radius, o, d,
                            f"bigmesh bounce {b}")
        k = tri_nearest_hit_stream(tab, boxes, o, d, al)
        k11_inputs += [(f"bounce {b}, spheres", hs.idx, big.n_pad, 12),
                       (f"bounce {b}, triangles", k.idx, big.tris.n_pad, 17)]
        k2 = tri_nearest_hit_stream(tab, boxes, o, d, al)
        lanes = torch.arange(0, r, SLICE_STRIDE, device=dev)
        p = tri_stream_plain(tab, boxes, o, d, al, lanes=lanes)
        full = tri_nearest_hit(tab, o, d)
        torch.cuda.synchronize()
        require(torch.equal(k.idx, k2.idx) and bits_equal(torch, k.t, k2.t),
                f"K10 bounce {b}: two launches differ")
        require(torch.equal(k.idx[lanes], p.idx)
                and bits_equal(torch, k.t[lanes], p.t),
                f"K10 bounce {b}: differs from plain on 1 lane in 32")
        require(bool((k.t[~al] == 1e30).all()),
                f"K10 bounce {b}: a dead lane hit")
        diff = al & ((k.idx != full.idx) | (k.t.view(torch.int32)
                                             != full.t.view(torch.int32)))
        fh = al & (full.t < 1e29)
        pt_ = o + d * full.t[:, None]
        bx = boxes[(full.idx.long() // TRI_BLOCK_M).clamp(max=n_tiles - 1)]
        inside = fh & ((pt_ >= bx[:, 0:3]) & (pt_ <= bx[:, 3:6])).all(1)
        n_diff = int(diff.sum())
        require(not bool((diff & inside).any()),
                f"K10 bounce {b}: {int((diff & inside).sum())} lanes differ "
                f"from K7 where K7's hit lies inside its tile's box")
        ms_k = cuda_ms(torch, lambda: tri_nearest_hit_stream(
            tab, boxes, o, d, al), 3)
        # K7, K10's reference here: its time, its slices, and its bound
        # over every pair (counted on 1 lane in 1024)
        ms_7 = cuda_ms(torch, lambda: tri_nearest_hit(tab, o, d), 1)
        sl7 = torch.arange(0, r, 1024, device=dev)
        f7, _ = mt_work(torch, tab, o[sl7], d[sl7])
        b7 = bound(f7 * r / sl7.shape[0], r * 32 + n_tri_real * TRI_BYTES)
        _, ms_p = timed(torch, lambda: tri_stream_plain(tab, boxes, o, d, al,
                                                        lanes=lanes))
        checks[b] = dict(alive=int(al.sum()), hits=int((k.t < 1e29).sum()),
                         lanes_differing_from_k7=n_diff, k10_ms=ms_k,
                         k7_ms=ms_7, k7_slices=tri_slices(r, tab.shape[0],
                                                          dev),
                         k7_bound_ms=b7[0], plain_ms=ms_p,
                         plain_lanes=int(lanes.shape[0]))
        print(f"K10 check, bigmesh bounce {b} ({w}x{h}, sample 0, "
              f"{'sorted' if b else 'primary'}): {checks[b]['alive']} alive "
              f"lanes, {checks[b]['hits']} hits; bit-equal to plain on 1 "
              f"lane in 32, two launches bit-equal, {n_diff} alive lanes "
              f"differ from K7 (none with K7's hit inside its tile's box); "
              f"K10 {ms_k:.3f} ms, K7 {ms_7:.3f} ms (CUDA events; "
              f"{checks[b]['k7_slices']} slice(s), bound {b7[0]:.3f} ms by "
              f"{b7[1]}), plain {ms_p:.1f} ms on the slice; K1 bit-equal to "
              f"plain in {k1_sl} slice(s) (its pick) and in 1, 2 and 7",
              flush=True)
    flops = nbytes = tested_flops = 0.0
    reach_sum = live_blocks = 0
    listed = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    per_bounce = []
    for b, (o, d, al) in enumerate(states):
        st = init_state(o, d, torch.zeros(r, dtype=torch.int64, device=dev))
        st[12] = al.float()
        reach = _block_reach(boxes, st)                       # [B,T]
        listed |= reach.any(0)
        live = int(reach.any(1).sum())
        n_reach = int(reach.sum())
        reach_sum += n_reach
        live_blocks += live
        sl = torch.arange(0, r, SLICE_STRIDE, device=dev)
        sl = sl[al[sl]]
        f, shares = 0.0, {}
        if sl.numel():
            f, shares = mt_work(torch, tab, o[sl], d[sl], reach[sl // BLOCK_R])
            f *= float(al.sum()) / sl.numel()
        flops += f
        # each lane's ray and alive flag in, its t and idx out
        nbytes += r * (24 + 1 + 8)
        ms_b = cuda_ms(torch, lambda: tri_nearest_hit_stream(
            tab, boxes, o, d, al), 3)
        # the kernel's counters: its lists are the plain version's, and it
        # tests at most the listed pairs; the list build timed alone
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
        tri_nearest_hit_stream(tab, boxes, o, d, al, stats=stats)
        k_listed, k_live, k_tested = stats.tolist()
        lanes_of = torch.nn.functional.pad(al, (0, -r % BLOCK_R)).view(
            -1, BLOCK_R).sum(1)
        pairs = int((reach.sum(1) * lanes_of).sum()) * TRI_BLOCK_M
        require(k_listed == n_reach and k_live >= live
                and k_tested <= pairs,
                f"K10 bounce {b}: counters {stats.tolist()} against "
                f"{n_reach} listed tiles, {live} live blocks, {pairs} pairs")
        ms_lists = cuda_ms(torch, lambda: tri_nearest_hit_stream(
            tab, boxes, o, d, al, lists_only=True), 3)
        tested_flops += k_tested * pair_flops(shares)
        per_bounce.append(dict(
            bounce=b, alive=int(al.sum()), live_blocks=live,
            tiles_per_live_block=n_reach / max(live, 1), flops=f,
            bound_ms=bound(f, r * (24 + 1 + 8))[0], k10_ms=ms_b,
            lists_only_ms=ms_lists, list_share=ms_lists / ms_b,
            pairs_listed=pairs, pairs_tested=k_tested))
    nbytes += float(listed.sum()) * TRI_BLOCK_M * TRI_BYTES + boxes.numel() * 4
    k10_bound = bound(flops, nbytes)
    k10_tbound = bound(tested_flops, nbytes)
    pass_rate = reach_sum / max(live_blocks * n_tiles, 1)
    print(f"K10 bound over the pass's {len(states)} bounces: "
          f"{flops:.6e} flops over the listed pairs, {nbytes:.6e} B -> "
          f"{k10_bound[0]:.3f} ms by {k10_bound[1]}; over the pairs tested "
          f"{tested_flops:.6e} flops -> {k10_tbound[0]:.3f} ms by "
          f"{k10_tbound[1]}; list pass rate {pass_rate:.4f} ({reach_sum} "
          f"listed tiles over {live_blocks} live block-bounces x {n_tiles} "
          f"tiles); per bounce (CUDA events): "
          + "; ".join(f"{p['bounce']}: {p['alive']} alive, "
                      f"{p['tiles_per_live_block']:.1f} tiles a live block, "
                      f"K10 {p['k10_ms']:.3f} ms (lists alone "
                      f"{p['lists_only_ms']:.3f} ms, "
                      f"{100 * p['list_share']:.1f}%), bound "
                      f"{p['bound_ms']:.3f} ms, pairs tested "
                      f"{p['pairs_tested']} of {p['pairs_listed']} listed"
                      for p in per_bounce),
          flush=True)
    phase("big_stream_check", t0)

    # 30b. K11 (the payload gathers' backward) at the main path's own
    # winners: the sphere and triangle idx of the primary rays and of the
    # sorted bounce-1 state (every miss and dead lane on row 0), and all
    # lanes on row 0 of the triangle table; cotangents from a seeded
    # generator. Each bit for bit against its plain version, two launches
    # bit-equal, rows no lane gathers +0.0, timed beside the two PyTorch
    # calls that compute the same function
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k11_inputs.append(("all lanes on row 0, triangles",
                       torch.zeros(r, dtype=torch.int32, device=dev),
                       big.tris.n_pad, 17))
    k11_checks = {what: k11_held(torch, idx, n, w, what, gen)
                  for what, idx, n, w in k11_inputs}
    phase("k11_check", t0)

    # 31. the main path as the CLI drives it: PathTracer.step on bigmesh,
    # backend fused (it falls back to the probe route: K1 + K10), two
    # calls; one more under torch.profiler for K10's device time; its
    # image equal to backend cuda's over the same tile-ordered lanes; one
    # call at ray_chunk=43200 (bench.py's chunk for this scene), its
    # differing pixels counted
    t0 = time.perf_counter()

    def tracer_of(chunk=None):
        return PathTracer(RenderConfig(
            scene=name, width=w, height=h, spp=spp, backend="fused",
            seed=SEED, max_bounces=MAX_BOUNCES, ray_chunk=chunk), scene=big,
            device=dev)

    tracer = tracer_of()
    secs, launches = [], None
    for _ in range(2):
        state0 = tracer.init_state()
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        state, rays = tracer.step(state0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        launches = counts()
        n_b = launches["tri_nearest_hit_stream"]
        require(1 <= n_b <= MAX_BOUNCES
                and launches["sphere_nearest_hit"] == n_b
                and sum(launches.values()) == 2 * n_b,
                f"bigmesh pass launched {launches}")
    require(tuple(state.mean.shape) == (h, w, 3)
            and bool(torch.isfinite(state.mean).all())
            and state.mean.mean().item() > 0.01,
            "bigmesh image is not finite and non-black")
    with torch.no_grad():
        c_cuda, rays_c = render_pixels(big, cam, pixel, width=w, height=h,
                                       spp=spp, sample_start=0, seed=SEED,
                                       max_bounces=MAX_BOUNCES,
                                       backend="cuda")
    require(rays_c == rays and torch.equal(state.mean, accumulate(
        tracer.init_state(), untile_image(c_cuda, w, h, inv), spp).mean),
        "bigmesh fused pass differs from backend cuda's")
    before = counts()["tri_nearest_hit_stream"]
    (state_p, _), prof_wall, by_key, busy = profiled(
        torch, lambda: tracer.step(tracer.init_state()))
    require(counts()["tri_nearest_hit_stream"] - before == n_b,
            "the profiled bigmesh pass launched K10 differently")
    require(torch.equal(state_p.mean, state.mean),
            "the profiled bigmesh pass differs")
    k10_ms = kernel_ms(by_key, k10_names)
    k1_ms = kernel_ms(by_key, K1_NAMES)
    o0, d0, _ = states[0]
    k1_paths["bigmesh pass"] = k1_path(
        torch, big.center, big.radius, o0, d0, n_b, k1_ms,
        f"render --scene bigmesh --backend fused {w}x{h} {spp} spp (the "
        f"probe route): {n_b} launches of {r} rays x {big.n_pad} slots; "
        f"ms_launch on the primary state",
        ms_launch_bounce_1=queued_ms(torch, lambda: sphere_nearest_hit(
            big.center, big.radius, states[1][0], states[1][1]), 20))
    require(k10_ms > 0, "torch.profiler recorded no K10 time")
    idle = 1.0 - busy / 1e3 / prof_wall
    tracer_c = tracer_of(BIG_CHUNK)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state_ch, rays_ch = tracer_c.step(tracer_c.init_state())
    torch.cuda.synchronize()
    secs_chunk = time.perf_counter() - t
    _, prof_wall_ch, by_key_ch, busy_ch = profiled(
        torch, lambda: tracer_c.step(tracer_c.init_state()))
    k10_ms_ch = kernel_ms(by_key_ch, k10_names)
    n_px_chunk = int((state_ch.mean != state.mean).any(-1).sum())
    require(n_px_chunk <= 20,
            f"bigmesh at ray_chunk={BIG_CHUNK} differs on {n_px_chunk} "
            f"pixels")
    print(f"bigmesh main path: render --scene bigmesh --backend fused "
          f"{w}x{h} {spp} spp (the probe route past the residency rule): "
          f"{rays} rays in {secs} s = {[rays / t for t in secs]} rays/s on "
          f"{card}; launches {launches}; image equal to backend cuda's; "
          f"profiled: {prof_wall:.3f} s wall, K10 {k10_ms:.3f} ms, K1 "
          f"{k1_ms:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{idle:.3f}); at ray_chunk={BIG_CHUNK}: {secs_chunk:.3f} s, "
          f"{rays_ch} rays, {n_px_chunk} pixels differ; profiled "
          f"{prof_wall_ch:.3f} s wall, K10 {k10_ms_ch:.3f} ms, device busy "
          f"{busy_ch:.3f} ms", flush=True)
    phase("big_main_path", t0)

    # 32. forward+backward as a user differentiates it (bench.py's and
    # examples/08_big_meshes.py's remat="save_hits"): image_mse(render_mean
    # (...), 0).backward() w.r.t. every scene leaf and the camera, three
    # calls; the backward launches no K10 and no K1; the gradients finite,
    # nonzero and within 3e-3 of each group's max of remat=False's
    t0 = time.perf_counter()

    def fwd_bwd(remat):
        sc, cm = trainable_scene(big), trainable_camera(cam)
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        img, rays_g = render_mean(sc, cm, width=w, height=h, spp=spp,
                                  seed=SEED, max_bounces=MAX_BOUNCES,
                                  backend="fused", remat=remat,
                                  return_rays=True)
        fwd = counts()
        image_mse(img, torch.zeros_like(img)).backward()
        torch.cuda.synchronize()
        secs_g = time.perf_counter() - t
        bwd = {k: v - fwd[k] for k, v in counts().items()}
        g = {k: sc.leaf(k).grad for k in sc.leaves}
        g.update(position=cm.position.grad, look_at=cm.look_at.grad)
        return g, rays_g, fwd, bwd, secs_g

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    step_secs = []
    for _ in range(3):
        g_s, rays_g, fwd_l, bwd_l, t_s = fwd_bwd("save_hits")
        step_secs.append(t_s)
    peak = torch.cuda.max_memory_allocated() - mem0
    require(rays_g == rays, f"bigmesh fwd+bwd rays {rays_g} != {rays}")
    require(fwd_l == launches and sum(searches(bwd_l).values()) == 0
            and bwd_l[K11] > 0,
            f"bigmesh fwd+bwd launches: forward {fwd_l}, backward {bwd_l} "
            f"(no search, K11)")
    for k, v in g_s.items():
        require(v is not None and bool(torch.isfinite(v).all()),
                f"bigmesh gradient of {k} missing or not finite")
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo", "position"):
        require(g_s[k].abs().max().item() > 0,
                f"bigmesh gradient of {k} is zero")
    torch.cuda.reset_peak_memory_stats()
    mem0_f = torch.cuda.memory_allocated()
    g_f, _, _, bwd_f, secs_f = fwd_bwd(False)
    peak_f = torch.cuda.max_memory_allocated() - mem0_f
    err = {k: ((g_s[k] - g_f[k]).abs().max()
               / g_f[k].abs().max().clamp_min(1e-12)).item() for k in g_f}
    require(max(err.values()) <= 3e-3,
            f"bigmesh save_hits gradients differ from remat=False's: {err}")
    # one more step under torch.profiler: where the step's device time goes
    (g_p, _, _, bwd_p, _), step_prof_wall, by_key_s, busy_s = profiled(
        torch, lambda: fwd_bwd("save_hits"))
    require(sum(searches(bwd_p).values()) == 0 and bwd_p[K11] > 0,
            f"the profiled step's backward launched {bwd_p} (no search, "
            f"K11)")
    require(all(torch.equal(g_p[k], g_s[k]) for k in g_s),
            "the profiled bigmesh step's gradients differ")
    step_k10_ms = kernel_ms(by_key_s, k10_names)
    step_k11_ms = kernel_ms(by_key_s, K11_NAMES)
    require(step_k11_ms > 0, "torch.profiler recorded no K11 time")
    k1_paths["bigmesh fwd+bwd step"] = dict(
        k1_paths["bigmesh pass"], ms=kernel_ms(by_key_s, K1_NAMES),
        launches=fwd_l["sphere_nearest_hit"],
        shape=f"fwd+bwd step, remat=save_hits: "
              f"{fwd_l['sphere_nearest_hit']} launches in the forward, none "
              f"in the backward; ms_launch and bound: the pass's")
    step_top = sorted(by_key_s.items(), key=lambda kv: -kv[1])[:5]
    step_idle = 1.0 - busy_s / 1e3 / step_prof_wall
    print(f"bigmesh fwd+bwd (remat=save_hits): {rays_g} rays, steps "
          f"{step_secs} s = {[rays_g / t for t in step_secs]} rays/s on "
          f"{card}; launches forward {fwd_l}, backward {bwd_l}; peak "
          f"{peak} B above {mem0} B; remat=False: {secs_f:.3f} s, peak "
          f"{peak_f} B, backward launches {bwd_f}; gradients within "
          f"{max(err.values()):.3e} of each group's max of remat=False's; "
          f"profiled step {step_prof_wall:.3f} s wall, device busy "
          f"{busy_s:.3f} ms (idle share {step_idle:.3f}), K10 "
          f"{step_k10_ms:.3f} ms, K11 {step_k11_ms:.3f} ms ({bwd_p[K11]} "
          f"launches in the backward), top device kernels "
          + "; ".join(f"{k[:80]} {v:.3f} ms" for k, v in step_top),
          flush=True)
    phase("big_fwd_bwd", t0)

    # 32b. the same step with remat="save_hits_bounce" (each bounce
    # recomputed on its own from its own stretch of the tape): the forward
    # launches K1 and K10 as "save_hits" does, the backward none; every
    # gradient within tests/test_grad.py:140-146's bound of the
    # "save_hits" step's; wall time and peak memory beside that step's
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0_b = torch.cuda.memory_allocated()
    g_b, rays_b, fwd_b, bwd_b, secs_b = fwd_bwd("save_hits_bounce")
    peak_b = torch.cuda.max_memory_allocated() - mem0_b
    require(rays_b == rays, f"bigmesh save_hits_bounce rays {rays_b}")
    require(fwd_b == launches and fwd_b["sphere_nearest_hit"] > 0
            and fwd_b["tri_nearest_hit_stream"] > 0
            and sum(searches(bwd_b).values()) == 0 and bwd_b[K11] > 0,
            f"bigmesh save_hits_bounce launches: forward {fwd_b}, "
            f"backward {bwd_b}")
    err_b = {}
    for k, v in g_s.items():
        scale = v.abs().max().item()
        d = (g_b[k] - v).abs()
        err_b[k] = d.max().item() / max(scale, 1e-30)
        require(bool(torch.isfinite(g_b[k]).all()) and bool(
            (d <= 1e-7 + 1e-5 * scale + 1e-4 * v.abs()).all()),
            f"bigmesh save_hits_bounce gradient of {k} off the save_hits "
            f"step's by {err_b[k]:.3e} of its max")
    k1_paths["bigmesh save_hits_bounce step"] = dict(
        k1_paths["bigmesh pass"], ms=None,
        launches=fwd_b["sphere_nearest_hit"],
        shape=f"fwd+bwd step, remat=save_hits_bounce: "
              f"{fwd_b['sphere_nearest_hit']} launches in the forward, none "
              f"in the backward; ms_launch and bound: the pass's; ms: not "
              f"profiled")
    print(f"bigmesh fwd+bwd (remat=save_hits_bounce): {rays_b} rays, step "
          f"{secs_b:.3f} s, peak {peak_b} B above {mem0_b} B; "
          f"save_hits: steps {step_secs} s, peak {peak} B; launches forward "
          f"{fwd_b}, backward {bwd_b}; gradients within "
          f"{max(err_b.values()):.3e} of each group's max of save_hits' "
          f"(rtol 1e-4, atol 1e-7 + 1e-5 x max)", flush=True)
    phase("big_save_hits_bounce", t0)

    # 33. the flat estimator on fused past the rule: it warns and falls
    # back to the eager estimator, equal to backend cuda's over the same
    # tile-ordered lanes
    t0 = time.perf_counter()
    ew, eh = BIG_EST
    eperm, einv = tile_order(ew, eh)
    epx = torch.as_tensor(eperm, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reset_counts()
        e_f, er_f = render_pixels(big, cam, epx, width=ew, height=eh, spp=1,
                                  sample_start=0, seed=SEED,
                                  backend="fused", shading="flat")
        est_launches = counts()
    require(any("streaming" in str(c.message) for c in caught),
            "the fused flat estimator on bigmesh did not warn")
    require(est_launches["simple_trace"] == 0
            and est_launches["tri_nearest_hit_stream"] == 1,
            f"bigmesh flat launched {est_launches}")
    e_c, er_c = render_pixels(big, cam, epx, width=ew, height=eh, spp=1,
                              sample_start=0, seed=SEED, backend="cuda",
                              shading="flat")
    require(er_f == er_c == ew * eh and torch.equal(e_f, e_c),
            "bigmesh flat on fused differs from backend cuda's")
    print(f"bigmesh flat estimator {ew}x{eh} on fused: warns, falls back "
          f"(launches {est_launches}), equal to backend cuda's", flush=True)
    phase("big_estimator", t0)

    kernels = {"tri_nearest_hit_stream": dict(
        name="tri_nearest_hit_stream", route="cuda",
        source="tpu_ray_torch/csrc/tri_stream.cu",
        replaces="tpu_ray/kernels/tri_intersect.py:315",
        launches=launches["tri_nearest_hit_stream"], max_abs_err=0.0,
        ms=k10_ms, plain_ms=checks[1]["plain_ms"], bound_ms=k10_tbound[0],
        bound_by=k10_tbound[1], library_ms=None,
        path=f"render --scene bigmesh --backend fused {w}x{h} {spp} spp",
        shape=f"{launches['tri_nearest_hit_stream']} launches of {r} lanes "
              f"x {n_tri_real} triangles in {n_tiles} tiles; ms and bound: "
              f"the whole pass (torch.profiler); plain: bounce 1, 1 lane in "
              f"32; the bound is over the pairs the front-to-back fold "
              f"tested (its counters), each priced by the listed pairs' "
              f"exit mix", list_pass_rate=pass_rate,
        checks=checks, bound_listed_pairs_ms=k10_bound[0],
        pairs_listed=sum(p["pairs_listed"] for p in per_bounce),
        pairs_tested=sum(p["pairs_tested"] for p in per_bounce),
        plain_lanes=checks[1]["plain_lanes"],
        ms_same_lanes=checks[1]["k10_ms"],
        same_lanes="bounce 1's sorted state, every lane",
        launches_save_hits_bounce_step=fwd_b["tri_nearest_hit_stream"])}
    k11_main = k11_checks["bounce 1, triangles"]
    kernels[K11] = dict(
        name=K11, route="cuda", source="tpu_ray_torch/csrc/gather_rows.cu",
        replaces="tpu_ray/ops/intersect.py:81",
        replaces_note="_gather_rows_bwd, the custom VJP of gather_rows "
                      "(tpu_ray/ops/intersect.py:64-92); not a pallas_call",
        launches=bwd_l[K11], max_abs_err=0.0, ms=k11_main["ms"],
        plain_ms=k11_main["plain_ms"], bound_ms=k11_main["bound_ms"],
        bound_by=k11_main["bound_by"], order_bytes=k11_main["order_bytes"],
        order_ms=k11_main["order_ms"], library_ms=k11_main["autograd_ms"],
        library_call="autograd of table[idx] (IndexBackward0: index_put_ "
                     "with accumulate)",
        library_index_add_ms=k11_main["index_add_ms"],
        path=f"image_mse(render_mean(bigmesh, {w}x{h}, {spp} spp, backend "
             f"fused, remat='save_hits'), 0).backward()",
        shape=f"launches: the step's backward ({bwd_l[K11]}); ms, plain, "
              f"bound and library: one call on bounce 1's triangle winners "
              f"({r} lanes into [{big.tris.n_pad},17]), CUDA events, the "
              f"stable sort included",
        checks=k11_checks,
        paths={"bigmesh fwd+bwd step, remat=save_hits": dict(
                   launches=bwd_l[K11], ms_profiled=step_k11_ms),
               "bigmesh fwd+bwd step, remat=False": dict(
                   launches=bwd_f[K11]),
               "bigmesh fwd+bwd step, remat=save_hits_bounce": dict(
                   launches=bwd_b[K11])})
    summary = dict(
        width=w, height=h, spp=spp, triangles=n_tri_real, rays_cast=rays,
        seconds=secs, rays_per_s=[rays / t for t in secs],
        seconds_ray_chunk_43200=secs_chunk, pixels_differing_chunked=n_px_chunk,
        k10_ms_ray_chunk_43200=k10_ms_ch,
        device_idle_share=idle, k10_ms=k10_ms, k1_ms=k1_ms,
        k10_per_bounce=per_bounce, fwd_bwd_device_idle_share=step_idle,
        fwd_bwd_top_device_ms=dict(step_top),
        fwd_bwd_k11_ms=step_k11_ms, fwd_bwd_k11_launches=bwd_p[K11],
        fwd_bwd_seconds=step_secs,
        fwd_bwd_rays_per_s=[rays_g / t for t in step_secs],
        fwd_bwd_peak_bytes=peak, fwd_bwd_remat_false_seconds=secs_f,
        fwd_bwd_remat_false_peak_bytes=peak_f, grad_max_rel_err=err,
        list_pass_rate=pass_rate,
        save_hits_bounce=dict(
            fwd_bwd_seconds=secs_b, fwd_bwd_peak_bytes=peak_b,
            save_hits_fwd_bwd_seconds=step_secs,
            save_hits_fwd_bwd_peak_bytes=peak,
            grad_max_rel_err_vs_save_hits=err_b))
    return kernels, summary


def surface_phases(torch, dev, card, reset_counts, counts, scene):
    """Phases 34-36: the CLI's progressive surface and sharding, on the
    main path's configuration (rtweekend 1920x1080, fused + regen, K2 and
    K2-record/K3), each driven with the counts set to 0 just before it and
    read just after. 34: ``cli.main(["render", ...])`` at 64 spp, 2 passes
    with --metrics and --profile, against 1 pass with --checkpoint, then
    --resume for 1 more (the two means bit-equal, the rays equal; a
    log_pass line a pass; the trace names K2's kernel). 35: ``animate``,
    3 frames at 4 spp, each frame's PNG byte for byte a
    ``PathTracer.step`` at that orbit camera. 36: a 1-rank ``nccl`` group
    and a mesh of 1: ``render_pass_sharded`` at 64 spp bit-equal to
    ``render_pass``, ``render_mean_sharded`` forward+backward within 3e-3
    of each group's max of one process's. -> ({kernel key: {field:
    launches}}, numbers)."""
    import socket
    from tpu_ray_torch import PathTracer, RenderConfig, cli, orbit_camera
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import (image_mse, render_mean,
                                    render_mean_sharded)
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.parallel import make_mesh, render_pass_sharded
    from tpu_ray_torch.parallel.multihost import ensure_initialized
    from tpu_ray_torch.utils import load_checkpoint, write_png

    out, extra = {}, {}
    base = ["render", "--scene", "rtweekend", "--width", str(MAIN_W),
            "--height", str(MAIN_H), "--spp", str(MAIN_SPP), "--backend",
            "fused", "--regen", "--seed", str(SEED)]

    def driven(fn):
        """(fn(), wall s, the launches it made)."""
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t, counts()

    def only(launched, what, **want):
        got = {k: v for k, v in launched.items() if v}
        require(got == want, f"{what} launched {launched}, not {want}")

    with tempfile.TemporaryDirectory() as tmp:
        def f(name):
            return os.path.join(tmp, name)

        # 34. resume and --profile, through the CLI
        t0 = time.perf_counter()
        rc, secs_full, l_full = driven(lambda: cli.main(
            base + ["--passes", "2", "--out", f("full.png"), "--checkpoint",
                    f("full.npz"), "--metrics", f("m.jsonl"), "--profile",
                    f("trace")]))
        require(rc == 0, "render --passes 2 failed")
        only(l_full, "render --passes 2", regen_steps=2)
        rc, secs_half, l_half = driven(lambda: cli.main(
            base + ["--passes", "1", "--out", f("half.png"), "--checkpoint",
                    f("half.npz"), "--metrics", f("h.jsonl")]))
        require(rc == 0, "render --passes 1 failed")
        rc, secs_res, l_res = driven(lambda: cli.main(
            ["render", "--resume", f("half.npz"), "--spp", str(MAIN_SPP),
             "--backend", "fused", "--regen", "--passes", "1", "--out",
             f("resumed.png"), "--checkpoint", f("resumed.npz"),
             "--metrics", f("r.jsonl")]))
        require(rc == 0, "render --resume failed")
        only(l_half, "render --passes 1", regen_steps=1)
        only(l_res, "render --resume", regen_steps=1)
        s_full, _, _, _, rays_full = load_checkpoint(f("full.npz"), dev)
        s_res, _, _, cfg_res, rays_res = load_checkpoint(f("resumed.npz"),
                                                         dev)
        require(s_full.samples == s_res.samples == 2 * MAIN_SPP
                and cfg_res.scene == "rtweekend", "resume: samples or scene")
        require(rays_full == rays_res > 0,
                f"resume: rays {rays_res} != uninterrupted {rays_full}")
        require(torch.equal(s_full.mean, s_res.mean),
                "the resumed mean is not the uninterrupted one's bit for bit")
        require(bool(torch.isfinite(s_full.mean).all())
                and s_full.mean.mean().item() > 0.01, "resume: image")
        with open(f("m.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        require([r["render_pass"] for r in rows] == [0, 1]
                and [r["samples"] for r in rows] == [MAIN_SPP, 2 * MAIN_SPP]
                and sum(r["rays_cast"] for r in rows) == rays_full,
                f"--metrics lines {rows}")
        traces = os.listdir(f("trace"))
        require(len(traces) == 1, f"--profile wrote {traces}")
        with open(os.path.join(f("trace"), traces[0])) as fh:
            text = fh.read()
        require("regen_sph_kernel" in text,
                "the --profile trace does not name K2 (regen_sph_kernel)")
        print(f"resume: rtweekend {MAIN_W}x{MAIN_H} {MAIN_SPP} spp fused+"
              f"regen on {card}: 2 passes (metrics, profiled) {secs_full:.3f}"
              f" s, 1 pass + checkpoint {secs_half:.3f} s, resume 1 pass "
              f"{secs_res:.3f} s (PNG and npz writes included); means bit-"
              f"equal, {rays_full} rays both; metrics {rows}; trace "
              f"{len(text)} B names regen_sph_kernel", flush=True)
        out["resume"] = dict(
            seconds_two_passes_profiled=secs_full,
            seconds_one_pass_checkpoint=secs_half,
            seconds_resumed_pass=secs_res, rays_cast=rays_full,
            pass_seconds=[r["seconds"] for r in rows],
            trace_bytes=len(text))
        extra["regen_steps"] = dict(launches_resume=l_full["regen_steps"])
        phase("cli_resume", t0)

        # 35. animate: each frame a PathTracer.step at its orbit camera
        t0 = time.perf_counter()
        frames, spp_a = 3, 4
        rc, secs_a, l_a = driven(lambda: cli.main(
            ["animate", "--scene", "rtweekend", "--width", str(MAIN_W),
             "--height", str(MAIN_H), "--spp", str(spp_a), "--frames",
             str(frames), "--backend", "fused", "--regen", "--seed",
             str(SEED), "--out-dir", f("frames"), "--metrics",
             f("a.jsonl")]))
        require(rc == 0, "animate failed")
        only(l_a, "animate", regen_steps=frames)
        tracer = PathTracer(RenderConfig(
            scene="rtweekend", width=MAIN_W, height=MAIN_H, spp=spp_a,
            backend="fused", seed=SEED, regen=True), scene=scene, device=dev)
        look_at = scene.look_at.cpu().numpy()
        for i in range(frames):
            angle = scene.default_x_angle + 2.0 * math.pi * i / frames
            cam_i = orbit_camera(look_at, scene.default_distance, angle,
                                 scene.default_y_height, device=dev)
            st, _ = tracer.step(tracer.init_state(), cam_i)
            write_png(f("ref.png"), tracer.srgb_image(st).cpu().numpy())
            with open(f("ref.png"), "rb") as a, open(os.path.join(
                    f("frames"), f"frame_{i:04d}.png"), "rb") as b:
                require(a.read() == b.read(),
                        f"animate frame {i} differs from PathTracer.step")
        with open(f("a.jsonl")) as fh:
            arows = [json.loads(line) for line in fh]
        require([r["frame"] for r in arows] == list(range(frames)),
                f"animate metrics {arows}")
        print(f"animate: {frames} frames {MAIN_W}x{MAIN_H} {spp_a} spp in "
              f"{secs_a:.3f} s (PNG writes included), each equal to "
              f"PathTracer.step; frame seconds "
              f"{[r['seconds'] for r in arows]}", flush=True)
        out["animate"] = dict(frames=frames, spp=spp_a, seconds=secs_a,
                              frame_seconds=[r["seconds"] for r in arows])
        extra["regen_steps"]["launches_animate"] = l_a["regen_steps"]
        phase("cli_animate", t0)

    # 36. sharding: a 1-rank nccl group, a mesh of 1
    t0 = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    ensure_initialized(init_method=f"tcp://localhost:{port}", world_size=1,
                       rank=0, device_type="cuda")
    mesh = make_mesh((1,), device_type="cuda")
    cam = default_camera(scene)
    kw = dict(width=MAIN_W, height=MAIN_H, spp=MAIN_SPP, seed=SEED,
              max_bounces=MAX_BOUNCES, backend="fused", regen=True)
    # two calls: the first sets up NCCL's communicator
    secs_sh = []
    for _ in range(2):
        (img_sh, rays_sh), secs, l_sh = driven(
            lambda: render_pass_sharded(scene, cam, mesh=mesh, **kw))
        only(l_sh, "render_pass_sharded", regen_steps=1)
        secs_sh.append(secs)
    (img_1, rays_1), secs_1, _ = driven(lambda: render_pass(scene, cam,
                                                            **kw))
    require(rays_sh == rays_1 and torch.equal(img_sh, img_1),
            "render_pass_sharded differs from render_pass")

    def step(sharded):
        sc, cm = trainable_scene(scene), trainable_camera(cam)
        if sharded:
            img = render_mean_sharded(sc, cm, mesh=mesh, **kw)
        else:
            img = render_mean(sc, cm, **kw)
        image_mse(img, torch.zeros_like(img)).backward()
        g = {k: sc.leaf(k).grad for k in sc.leaves}
        g.update(position=cm.position.grad, look_at=cm.look_at.grad)
        return g

    secs_g = []
    for _ in range(2):
        g_sh, secs, l_g = driven(lambda: step(True))
        only(l_g, "render_mean_sharded fwd+bwd", regen_record=1,
             regen_bwd=1)
        secs_g.append(secs)
    g_1, secs_g1, _ = driven(lambda: step(False))
    err = {k: ((g_sh[k] - g_1[k]).abs().max()
               / g_1[k].abs().max().clamp_min(1e-12)).item() for k in g_1}
    require(all(bool(torch.isfinite(v).all()) for v in g_sh.values())
            and max(err.values()) <= 3e-3,
            f"render_mean_sharded gradients off one process's: {err}")
    print(f"sharded, 1-rank nccl, mesh (1,): render_pass_sharded {MAIN_W}x"
          f"{MAIN_H} {MAIN_SPP} spp {secs_sh} s (render_pass {secs_1:.3f} s)"
          f", {rays_sh} rays, bit-equal to render_pass; render_mean_sharded "
          f"fwd+bwd {secs_g} s (render_mean {secs_g1:.3f} s), gradients "
          f"within {max(err.values()):.3e} of each group's max of one "
          f"process's", flush=True)
    out["sharded"] = dict(pass_seconds=secs_sh, render_pass_seconds=secs_1,
                          rays_cast=rays_sh, fwd_bwd_seconds=secs_g,
                          render_mean_fwd_bwd_seconds=secs_g1,
                          grad_max_rel_err=err)
    extra["regen_steps"]["launches_sharded_pass"] = l_sh["regen_steps"]
    extra["regen_record"] = dict(launches_sharded_step=l_g["regen_record"])
    extra["regen_bwd"] = dict(launches_sharded_step=l_g["regen_bwd"])
    phase("sharded", t0)
    return extra, out


# phase 37: the library examples (tpu_ray_torch/examples) at their
# defaults: (script, flags past them, the wrappers their defaults launch)
EXAMPLES = (
    ("01_progressive_render", [], ("bounce_fwd",)),
    ("02_custom_scene", [], ("bounce_fwd",)),
    ("03_pixel_gradients", [], ("bounce_fwd", "bounce_replay",
                                "bounce_bwd")),
    ("04_inverse_rendering", [], ("bounce_fwd", "bounce_replay",
                                  "bounce_bwd")),
    ("05_sharded_render", ["--mesh", "1"], ("sphere_nearest_hit",)),
    ("06_triangle_mesh", [], ("bounce_fwd_list",)),
    ("07_simple_estimators", [], ("simple_trace",)),
    ("08_big_meshes", ["--grad"], ("sphere_nearest_hit",
                                   "tri_nearest_hit_stream", K11)))
EX5_SPP = 2                 # 05_sharded_render.py's default --spp
# each counted wrapper's CUDA kernels as torch.profiler names them: all of
# `must` in an example's trace (K4 in its sphere mode), `names` summed
KERNEL_NAMES = {
    "bounce_fwd": dict(must=("bounce_fwd_kernel<false>",),
                       names=BOUNCE_KERNELS["bounce_fwd"]),
    "bounce_replay": dict(must=BOUNCE_KERNELS["bounce_replay"],
                          names=BOUNCE_KERNELS["bounce_replay"]),
    "bounce_bwd": dict(must=BOUNCE_KERNELS["bounce_bwd"],
                       names=BOUNCE_KERNELS["bounce_bwd"]),
    "bounce_fwd_list": dict(must=BOUNCE_KERNELS["bounce_fwd_list"],
                            names=BOUNCE_KERNELS["bounce_fwd_list"]),
    "sphere_nearest_hit": dict(must=K1_NAMES[:1], names=K1_NAMES),
    "simple_trace": dict(must=("simple_trace_kernel",),
                         names=("simple_trace_kernel",)),
    "tri_nearest_hit_stream": dict(must=("tri_stream_kernel",),
                                   names=("tri_stream_kernel",)),
    K11: dict(must=K11_NAMES[:1], names=K11_NAMES)}


@contextlib.contextmanager
def rays_counted():
    """Sum the rays cast of every render_pixels call (the renders of
    render_pass, render_mean and render_pass_sharded) into the yielded
    one-item list while the block runs."""
    from tpu_ray_torch.grad import render_grad
    from tpu_ray_torch.models import path_tracer
    from tpu_ray_torch.parallel import render
    inner, total = path_tracer.render_pixels, [0]

    def render_pixels(*args, **kw):
        color, rays = inner(*args, **kw)
        total[0] += int(rays)
        return color, rays

    mods = (path_tracer, render_grad, render)
    for mod in mods:
        mod.render_pixels = render_pixels
    try:
        yield total
    finally:
        for mod in mods:
            mod.render_pixels = inner


def example_phases(torch, dev, card, reset_counts, counts):
    """Phase 37: each library example's main() on the card at its
    defaults (its default backend, the flags of EXAMPLES), as a user runs
    it: a first call under torch.profiler, whose trace must name the
    kernels the example's route launches (KERNEL_NAMES), then a second
    call with the counts set to 0 just before and read just after (only
    EXAMPLES' wrappers launched, K4 in its culled sphere mode), its wall
    seconds, rays cast and peak device memory. Checks: 2's image on fused
    equal to backend cuda's; 3's fused gradients within 3e-3 of each
    group's max of backend cuda autograd; 4's albedo error falls; 5 (--mesh
    1, on phase 36's 1-rank nccl group, destroyed after it) bit-equal to
    render_pass; 6's fused image within 20 pixels of backend cuda's past
    rtol 1e-5 / atol 1e-6; 8 (--grad) gradients finite, the vertex norm
    nonzero. -> ({kernel key: {example: {launches, ms}}}, numbers)."""
    from tpu_ray_torch import default_camera, make_scene
    from tpu_ray_torch.kernels.bounce_step import bounce_fwd
    from tpu_ray_torch.models.path_tracer import render_pass

    ex_dir = os.path.join(HERE, "tpu_ray_torch", "examples")
    paths, out = {}, {}

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ex_dir, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, want in EXAMPLES:
            t0 = time.perf_counter()
            main_of = load(name).main
            png = ["--out", os.path.join(tmp, name + ".png")]
            argv = flags + (png if name[:2] not in ("03", "04") else [])
            got, wall_first, by_key, busy = profiled(
                torch, lambda: main_of(argv))
            for key in want:
                for kname in KERNEL_NAMES[key]["must"]:
                    require(any(kname in k for k in by_key),
                            f"example {name}: {kname} is not in its trace")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            reset_counts()
            with rays_counted() as rays:
                t = time.perf_counter()
                got = main_of(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            launched = {k: v for k, v in counts().items() if v}
            culled = bounce_fwd.culled_launches
            peak = torch.cuda.max_memory_allocated()
            require(set(launched) == set(want),
                    f"example {name} launched {launched}, not {want}")
            require("bounce_fwd" not in want
                    or culled == launched["bounce_fwd"],
                    f"example {name}: {culled} of {launched} K4 launches "
                    f"culled")
            rec = dict(seconds=wall, first_call_seconds_profiled=wall_first,
                       rays_cast=rays[0], rays_per_s=rays[0] / wall,
                       peak_bytes=peak, bytes_before=mem0,
                       launches=launched, device_busy_ms_profiled=busy)

            # the example's own checks
            if name == "02_custom_scene":
                ref = load(name).main(argv + ["--backend", "cuda"])
                require(torch.equal(got, ref), "example 02: the fused "
                        "image differs from backend cuda's")
            elif name == "03_pixel_gradients":
                ref_s, ref_c = load(name).main(argv + ["--backend", "cuda"])
                d_s, d_c = got
                err = {k: ((d_s.leaf(k) - ref_s.leaf(k)).abs().max()
                           / ref_s.leaf(k).abs().max().clamp_min(1e-12))
                       .item() for k in d_s.leaves}
                err.update({k: ((getattr(d_c, k) - getattr(ref_c, k))
                                .abs().max() / getattr(ref_c, k).abs().max()
                                .clamp_min(1e-12)).item()
                            for k in ("position", "look_at")})
                require(max(err.values()) < 3e-3, f"example 03: fused "
                        f"gradients off backend cuda autograd's: {err}")
                rec["grad_max_rel_err_vs_cuda"] = max(err.values())
            elif name == "04_inverse_rendering":
                _, err0, err = got
                require(err < err0, f"example 04: albedo error {err0} -> "
                        f"{err}")
                rec["albedo_error"] = [err0, err]
            elif name == "05_sharded_render":
                scene = make_scene("rtweekend", device=dev)
                img, rays_1 = render_pass(
                    scene, default_camera(scene), width=got.shape[1],
                    height=got.shape[0], spp=EX5_SPP, backend="cuda")
                require(torch.equal(got, img / EX5_SPP)
                        and rays[0] == rays_1,
                        "example 05 differs from render_pass")
                torch.distributed.destroy_process_group()
            elif name == "06_triangle_mesh":
                # K8's shading takes a triangle's plane form, the eager
                # route its edges: the two round apart by an ulp or so,
                # so pixels are counted past the goldens' bound
                ref = load(name).main(argv + ["--backend", "cuda"])
                n_px = int((~torch.isclose(got, ref, rtol=1e-5, atol=1e-6))
                           .any(-1).sum())
                require(n_px <= 20, f"example 06: the fused image differs "
                        f"from backend cuda's in {n_px} pixels")
                rec.update(pixels_differing_from_cuda=n_px,
                           pixels_not_bit_equal_to_cuda=int(
                               (got != ref).any(-1).sum()),
                           max_abs_diff_from_cuda=float(
                               (got - ref).abs().max()))
            elif name == "08_big_meshes":
                img, gs = got
                norm = float(torch.linalg.norm(gs.tris.v0))
                require(bool(torch.isfinite(img).all())
                        and all(bool(torch.isfinite(gs.leaf(k)).all())
                                for k in gs.leaves) and norm > 0,
                        f"example 08: gradients (|d v0| {norm})")
                rec["d_vertices_norm"] = norm
            for key in want:
                paths.setdefault(key, {})[f"example {name}"] = dict(
                    launches=launched[key],
                    ms_profiled_first_call=kernel_ms(
                        by_key, KERNEL_NAMES[key]["names"]))
            print(f"example {name} on {card}: {wall:.3f} s after a first "
                  f"call of {wall_first:.3f} s (profiled), {rays[0]} rays "
                  f"cast, peak {peak / 1e9:.3f} GB ({mem0 / 1e9:.3f} GB "
                  f"before), launches {launched}; {rec}", flush=True)
            out[name] = rec
            phase(f"example_{name[:2]}", t0)
    return paths, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import tpu_ray_torch
    pkg_dir = os.path.dirname(os.path.abspath(tpu_ray_torch.__file__))
    require(pkg_dir == os.path.join(HERE, "tpu_ray_torch"),
            f"tpu_ray_torch must come from this checkout, got {pkg_dir}")
    import numpy as np
    from tpu_ray_torch import PathTracer, RenderConfig
    from tpu_ray_torch.core.camera import default_camera, trainable_camera
    from tpu_ray_torch.core.scene import (SCENE_LEAVES, make_scene,
                                          trainable_scene)
    from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
    from tpu_ray_torch.kernels import build
    from tpu_ray_torch.kernels.bounce_step import (
        BLOCK_R, MERGE_STATS, TRI_BLOCK_M, _block_reach, bounce_bwd,
        bounce_bwd_lanes_plain, bounce_bwd_plain, bounce_cull_mask,
        bounce_cull_mask_octant,
        bounce_fwd, bounce_fwd_list, bounce_fwd_list_plain, bounce_fwd_plain,
        bounce_replay, bounce_replay_plain, cull_mask, fused_tables,
        init_state, make_fused_sample, morton_perm, origin_bound,
        permute_spheres, ray_block_bounds, tab_tile_boxes,
        table_sum_fixed_order, tile_bounds, tri_block_lists, tri_morton_perm)
    from tpu_ray_torch.kernels.regen import (
        SEG_MAX, regen_bwd, regen_bwd_info, regen_bwd_plain, regen_record,
        regen_steps, regen_steps_plain, regen_tables, sphere_tiles,
        wave_init)
    from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                        sphere_nearest_hit)
    from tpu_ray_torch.kernels.tri_intersect import (tri_hit_plain,
                                                     tri_nearest_hit,
                                                     tri_slices)
    from tpu_ray_torch.models.path_tracer import (render_pass, tile_order,
                                                  untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.utils.png import write_png

    from tpu_ray_torch.kernels.gather_rows import gather_rows_bwd
    from tpu_ray_torch.kernels.simple_shade import simple_trace
    from tpu_ray_torch.kernels.tri_intersect import tri_nearest_hit_stream

    counted = (sphere_nearest_hit, regen_steps, regen_record, regen_bwd,
               bounce_fwd, bounce_replay, bounce_bwd, tri_nearest_hit,
               bounce_fwd_list, simple_trace, tri_nearest_hit_stream,
               gather_rows_bwd)

    def reset_counts():
        for fn in counted:
            fn.launches = 0
        regen_steps.listed_launches = regen_record.listed_launches = 0
        regen_steps.culled_launches = regen_record.culled_launches = 0
        bounce_fwd.culled_launches = bounce_fwd.tri_launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counted}

    t_all = time.perf_counter()
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    info = build.build_info
    print(f"build: {info['seconds']:.3f} s "
          f"({'cached' if info['cached'] else 'nvcc'})", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())
    phase("build", t0)

    scene = make_scene("rtweekend", device=dev)
    # the regen route's table: the Morton-permuted scene's, as the route
    # builds it (its records and d_table are in permuted order)
    table, _, _ = regen_tables(scene)
    sperm = morton_perm(scene)
    # the bounds count the slots with r * r > 0: no other slot can hit (K1
    # folds only those)
    n_real = int((scene.radius * scene.radius > 0).sum())
    cam = default_camera(scene)
    kernels = {}

    # 3. K1 against its plain version: 2^16 random rays x rtweekend, bit
    # for bit in the slices it picks and in 1, 2 and 7
    t0 = time.perf_counter()
    g = np.random.default_rng(SEED)
    r1 = 1 << 16
    o = np.empty((r1, 3), np.float32)
    o[:, 0] = g.uniform(-0.8, 0.8, r1)
    o[:, 1] = g.uniform(0.0, 0.3, r1)
    o[:, 2] = g.uniform(-0.8, 0.8, r1)
    d = g.normal(size=(r1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.as_tensor(o, device=dev)
    d_t = torch.as_tensor(d, device=dev)
    hp, n_sl = k1_held(torch, scene.center, scene.radius, o_t, d_t,
                       "random rays")
    require(bool((hp.t < 1e29).any()), "K1: no random ray hits")
    print(f"K1 check, {r1} random rays x {scene.n_pad} slots ({n_real} "
          f"real): bit-equal to plain in {n_sl} slices (its pick) and in "
          f"1, 2 and 7, two launches bit-equal", flush=True)
    phase("k1_check", t0)

    # 4. K2 against its plain version: rtweekend 320x180, 4 spp
    t0 = time.perf_counter()
    perm, _ = tile_order(CHECK_W, CHECK_H)
    st0, c13, _ = wave_init(cam, torch.as_tensor(perm, device=dev),
                            CHECK_SPP, SEED, 0, CHECK_W, CHECK_H)
    kw = dict(use_sky=scene.use_sky, max_bounces=MAX_BOUNCES, width=CHECK_W,
              height=CHECK_H)
    st_k, st_p = st0.clone(), st0.clone()
    regen_steps(st_k, c13, table, CHECK_SPP * MAX_BOUNCES, **kw)
    regen_steps_plain(st_p, c13, table, CHECK_SPP * MAX_BOUNCES, **kw)
    torch.cuda.synchronize()
    rays_k = int(st_k[22].to(torch.int64).sum())
    rays_p = int(st_p[22].to(torch.int64).sum())
    require(rays_k == rays_p, f"K2: rays {rays_k} != plain {rays_p}")
    diff = (st_k[16:19] - st_p[16:19]).abs()
    mean_d, max_d = diff.mean().item(), diff.max().item()
    require(mean_d < 1e-5, f"K2: image mean |d| {mean_d} >= 1e-5")
    require(bits_equal(torch, st_k, st_p), "K2: state not bit-equal to plain")
    # the culled sphere search, as the route runs it
    st_c = st0.clone()
    regen_steps(st_c, c13, table, CHECK_SPP * MAX_BOUNCES,
                sph=sphere_tiles(table, float(cam.position.abs().max())),
                **kw)
    require(bits_equal(torch, st_c, st_p),
            "K2 culled: state not bit-equal to plain")
    print(f"K2 check, {CHECK_W}x{CHECK_H} {CHECK_SPP} spp: rays {rays_k}, "
          f"image mean |d| {mean_d}, max |d| {max_d}, state bit-equal, "
          f"the sweep and the culled search", flush=True)
    phase("k2_check", t0)

    # 5. the K1 path: render through K1 inside the bounce loop (backend
    # cuda), held against the same render with the plain search; one more
    # render under torch.profiler for K1's device time over the pass
    t0 = time.perf_counter()
    reset_counts()
    img, rays = render_pass(scene, cam, width=CHECK_W, height=CHECK_H,
                            spp=CHECK_SPP, backend="cuda", seed=SEED)
    torch.cuda.synchronize()
    k1_launches = sphere_nearest_hit.launches
    require(k1_launches > 0, "backend cuda did not launch K1")
    require(bool(torch.isfinite(img).all()) and img.mean().item() > 0,
            "backend cuda image is not finite and non-black")
    n_s = CHECK_SPP * CHECK_W * CHECK_H
    require(n_s <= rays <= n_s * MAX_BOUNCES, f"backend cuda rays {rays}")
    img_p, rays_p = render_pass(scene, cam, width=CHECK_W, height=CHECK_H,
                                spp=CHECK_SPP, backend="torch", seed=SEED)
    require(rays == rays_p, f"backend cuda rays {rays} != torch {rays_p}")
    img_d = (img - img_p).abs().max().item()
    require(torch.equal(img, img_p),
            f"backend cuda image differs from torch by max {img_d}")
    before = sphere_nearest_hit.launches
    (img_q, _), _, by_key_c, _ = profiled(torch, lambda: render_pass(
        scene, cam, width=CHECK_W, height=CHECK_H, spp=CHECK_SPP,
        backend="cuda", seed=SEED))
    require(sphere_nearest_hit.launches - before == k1_launches
            and torch.equal(img_q, img), "the profiled backend cuda pass "
            "launched K1 differently or differs")
    # K1 at the shape that path gives it: one bounce of every pixel
    o1, d1, _ = camera_rays(cam, CHECK_W, CHECK_H, torch.arange(
        CHECK_W * CHECK_H, device=dev), 0, SEED)
    hp, _ = k1_held(torch, scene.center, scene.radius, o1, d1,
                    "rtweekend primary rays")
    r1 = o1.shape[0]
    k1_plain = cuda_ms(torch, lambda: nearest_hit_plain(
        scene.center, scene.radius, o1, d1), 5)
    k1_paths = {"rtweekend, backend cuda": k1_path(
        torch, scene.center, scene.radius, o1, d1, k1_launches,
        kernel_ms(by_key_c, K1_NAMES),
        f"render backend=cuda {CHECK_W}x{CHECK_H} {CHECK_SPP} spp: "
        f"{k1_launches} launches of {r1} rays x {scene.n_pad} slots "
        f"({n_real} real)", memset_ms=kernel_ms(by_key_c, ("Memset",)))}
    k1_rt = k1_paths["rtweekend, backend cuda"]
    kernels["sphere_nearest_hit"] = dict(
        name="sphere_nearest_hit", route="cuda",
        source="tpu_ray_torch/csrc/sphere_intersect.cu",
        replaces="tpu_ray/kernels/sphere_intersect.py:204",
        launches=k1_launches, max_abs_err=0.0, ms=k1_rt["ms_launch"],
        plain_ms=k1_plain, bound_ms=k1_rt["bound_ms"] / k1_launches,
        bound_by=k1_rt["bound_by"], library_ms=None,
        path=f"render backend=cuda {CHECK_W}x{CHECK_H} {CHECK_SPP} spp",
        shape=f"{r1} rays x {scene.n_pad} slots ({n_real} real) in "
              f"{k1_rt['slices']} slices; ms: a launch (CUDA events); "
              f"bit-equal to plain; every path that launches it in paths",
        paths=k1_paths)
    print(f"backend cuda: {rays} rays, K1 launches {k1_launches}, image "
          f"equal to backend torch; K1 at {r1} primary rays bit-equal to "
          f"plain: {k1_rt['ms_launch']:.4f} ms a launch in "
          f"{k1_rt['slices']} slices (bound "
          f"{k1_rt['bound_ms'] / k1_launches:.4f} ms by "
          f"{k1_rt['bound_by']}), {k1_rt['ms']:.4f} ms over the pass "
          f"(torch.profiler; memsets {k1_rt['memset_ms']:.4f} ms) / plain "
          f"{k1_plain:.4f} ms", flush=True)
    phase("render_cuda", t0)

    # 6. the main path, as the CLI drives it
    t0 = time.perf_counter()
    cfg = RenderConfig(scene="rtweekend", width=MAIN_W, height=MAIN_H,
                       spp=MAIN_SPP, max_bounces=MAX_BOUNCES,
                       backend="fused", seed=SEED, regen=True)
    tracer = PathTracer(cfg, scene=scene, device=dev)
    state0 = tracer.init_state()
    torch.cuda.synchronize()
    reset_counts()
    t_main = time.perf_counter()
    state, rays = tracer.step(state0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t_main
    k2_launches = regen_steps.launches
    require(k2_launches > 0, "main path did not launch K2")
    require(regen_steps.culled_launches == k2_launches,
            "main path did not take K2's culled sphere search")
    require(sum(counts().values()) == k2_launches,
            f"forward path launched others: {counts()}")
    mean = state.mean
    require(tuple(mean.shape) == (MAIN_H, MAIN_W, 3), "main image shape")
    require(bool(torch.isfinite(mean).all()), "main image not finite")
    require(mean.mean().item() > 0.01, "main image is black")
    n_s = MAIN_SPP * MAIN_W * MAIN_H
    require(n_s <= rays <= n_s * MAX_BOUNCES, f"main rays {rays} out of range")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "rtweekend.png")
        write_png(png, tracer.srgb_image(state).cpu().numpy())
        png_bytes = os.path.getsize(png)
    print(f"main path: rtweekend {MAIN_W}x{MAIN_H} {MAIN_SPP} spp fused+regen"
          f": {rays} rays in {secs:.3f} s = {rays / secs:.6e} rays/s on "
          f"{card}; K2 launches {k2_launches}; png {png_bytes} B", flush=True)
    phase("main_path", t0)

    # 7. K2 at the main path's own state (launches not counted): the whole
    # launch, timed, must give the main path's image, and every 32nd lane
    # of it is held against the plain version over all its steps
    t0 = time.perf_counter()
    steps = MAIN_SPP * MAX_BOUNCES
    kwm = dict(use_sky=scene.use_sky, max_bounces=MAX_BOUNCES, width=MAIN_W,
               height=MAIN_H)
    perm, inv = tile_order(MAIN_W, MAIN_H)
    st0, c13, r2 = wave_init(tracer.camera, torch.as_tensor(perm, device=dev),
                             MAIN_SPP, SEED, 0, MAIN_W, MAIN_H)
    # the sphere tiles' host cost, as the route pays it once a pass and a
    # fwd+bwd step (kernels/regen.py _search_of): the table's copy to the
    # host, the tiling, the copy back, wall time to a synchronize
    tiles_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_tiles = time.perf_counter()
        sph = sphere_tiles(table, float(tracer.camera.position.abs().max()))
        torch.cuda.synchronize()
        tiles_ms.append(1e3 * (time.perf_counter() - t_tiles))
    st_k = st0.clone()
    _, k2_ms = timed(torch, lambda: regen_steps(st_k, c13, table, steps,
                                                sph=sph, **kwm))
    rays_k = int(st_k[22].to(torch.int64).sum())
    require(rays_k == rays, f"K2 launch rays {rays_k} != main path {rays}")
    again = accumulate(tracer.init_state(), untile_image(
        st_k[16:19].T, MAIN_W, MAIN_H, inv), MAIN_SPP)
    require(torch.equal(again.mean, mean),
            "K2 launch image differs from the main path's")
    # the sweep of every sphere (the sphere mode before the cull), timed in
    # turns with the culled search: culled, sweep, culled, sweep, culled
    k2_cull_ms, k2_sweep_ms = [k2_ms], []
    for _ in range(2):
        st_s = st0.clone()
        k2_sweep_ms.append(timed(torch, lambda: regen_steps(
            st_s, c13, table, steps, **kwm))[1])
        require(bits_equal(torch, st_s, st_k),
                "K2's sweep ends in another state than the culled search")
        st_s = st0.clone()
        k2_cull_ms.append(timed(torch, lambda: regen_steps(
            st_s, c13, table, steps, sph=sph, **kwm))[1])
    del st_s
    k2_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    regen_steps(st0.clone(), c13, table, steps, sph=sph, stats=k2_stats,
                **kwm)
    k2_boxes, k2_folded, k2_pairs = k2_stats.tolist()
    cols = slice(None, None, SLICE_STRIDE)
    sl_k, sl_p = st0[:, cols].contiguous(), st0[:, cols].contiguous()
    sl_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    _, k2_ms_slice = timed(torch, lambda: regen_steps(
        sl_k, c13, table, steps, sph=sph, stats=sl_stats, **kwm))
    _, k2_plain = timed(torch, lambda: regen_steps_plain(sl_p, c13, table,
                                                         steps, **kwm))
    require(bits_equal(torch, sl_k, st_k[:, cols]),
            "K2 on the lane slice differs from the whole launch")
    require(torch.equal(sl_p[22], sl_k[22]), "K2: slice rays counter differs")
    k2_err = (sl_p[16:19] - sl_k[16:19]).abs().max().item()
    require(bits_equal(torch, sl_p, sl_k),
            f"K2: slice state not bit-equal to plain (image max |d| {k2_err})")
    # the plain mirror of the culled search skips the tiles the kernel
    # skips: the same counts on the slice, and the same state
    sl_m = st0[:, cols].contiguous()
    mir_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    _, k2_mirror = timed(torch, lambda: regen_steps_plain(
        sl_m, c13, table, steps, sph=sph, stats=mir_stats, **kwm))
    require(bits_equal(torch, sl_m, sl_p),
            "K2's plain mirror of the cull differs from the plain version")
    require(torch.equal(mir_stats, sl_stats),
            f"K2 culled counts {sl_stats.tolist()} differ from the plain "
            f"mirror's {mir_stats.tolist()}")
    # the bound counts the search alone (leaving out the shading and the
    # regeneration of each step only lowers it): the pairs and tile boxes
    # the culled search tested, beside the sweep of every real sphere
    k2_io = 2 * STATE_BYTES * r2 + n_real * SPHERE_BYTES + 52
    k2_bound, k2_by = bound(k2_pairs * FLOPS_PER_PAIR
                            + k2_boxes * FLOPS_PER_BOX, k2_io)
    k2_bound_all = bound(rays * n_real * FLOPS_PER_PAIR, k2_io)[0]
    k2_sph = dict(sphere_tiles=int(sph.boxes.shape[0]),
                  tile_boxes_tested=k2_boxes, tiles_folded=k2_folded,
                  pairs_tested=k2_pairs, pairs_every_sphere=rays * n_real,
                  sphere_tiles_host_ms=tiles_ms)
    kernels["regen_steps"] = dict(
        name="regen_steps", route="cuda", source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:868",
        also_replaces="tpu_ray/kernels/regen.py:769",
        launches=k2_launches, max_abs_err=k2_err, ms=k2_ms,
        plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
        library_ms=None,
        path=f"main: render fused+regen {MAIN_W}x{MAIN_H} {MAIN_SPP} spp",
        shape=f"{r2} lanes x {steps} steps, {rays} rays; culled sphere "
              f"search, bound over the pairs and boxes tested",
        plain_lanes=sl_p.shape[1], ms_same_lanes=k2_ms_slice,
        culled_ms=k2_cull_ms, sweep_ms=k2_sweep_ms,
        bound_every_sphere_ms=k2_bound_all, mirror_ms=k2_mirror, **k2_sph)
    print(f"K2 at the main path: {k2_ms:.3f} ms (bound {k2_bound:.3f} ms by "
          f"{k2_by} over the pairs tested, {k2_bound_all:.3f} ms over every "
          f"sphere); culled {k2_cull_ms} ms against the sweep of every "
          f"sphere {k2_sweep_ms} ms in turns, the same state; "
          f"{sph.boxes.shape[0]} tiles: {k2_boxes} tile boxes tested, "
          f"{k2_folded} tiles folded, {k2_pairs} ray-sphere pairs tested of "
          f"{rays * n_real} ({k2_pairs / (rays * n_real):.4f}); 1 lane in "
          f"{SLICE_STRIDE} ({sl_p.shape[1]}) bit-equal to plain, counts "
          f"equal to the plain mirror's, {k2_ms_slice:.3f} ms kernel / "
          f"{k2_plain:.3f} ms plain / {k2_mirror:.3f} ms mirror on those "
          f"lanes; sphere_tiles on the host {tiles_ms} ms wall", flush=True)
    phase("k2_main_check", t0)
    # 8. the forward+backward main path, as a user differentiates it:
    # image_mse(render_mean(...), 0).backward() w.r.t. every scene leaf and
    # the camera (bench.py's fwd+bwd step), fused + regen, three calls
    t0 = time.perf_counter()
    sc = trainable_scene(scene)
    cm = trainable_camera(tracer.camera)
    leaves = [getattr(sc, k) for k in SCENE_LEAVES] + [cm.position,
                                                       cm.look_at]
    target = torch.zeros((MAIN_H, MAIN_W, 3), dtype=torch.float32,
                         device=dev)

    def fwd_bwd():
        for leaf in leaves:
            leaf.grad = None
        img_g, rays_g = render_mean(sc, cm, width=MAIN_W, height=MAIN_H,
                                    spp=MAIN_SPP, seed=SEED,
                                    max_bounces=MAX_BOUNCES, backend="fused",
                                    regen=True, return_rays=True)
        image_mse(img_g, target).backward()
        return img_g.detach(), rays_g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    step_secs = []
    t_step = time.perf_counter()
    img_g, rays_g = fwd_bwd()
    torch.cuda.synchronize()
    step_secs.append(time.perf_counter() - t_step)
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - mem0
    require(launches["regen_record"] > 0, "fwd+bwd did not launch K2-record")
    require(launches["regen_bwd"] > 0, "fwd+bwd did not launch K3")
    require(regen_record.culled_launches == launches["regen_record"],
            "fwd+bwd did not take K2-record's culled sphere search")
    require(sum(launches.values()) == launches["regen_record"]
            + launches["regen_bwd"],
            f"fwd+bwd launched other kernels: {launches}")
    require(rays_g == rays, f"fwd+bwd rays {rays_g} != forward {rays}")
    require(torch.equal(img_g, mean),
            "recording forward's image differs from the forward path's")
    grads = {k: getattr(sc, k).grad for k in SCENE_LEAVES}
    grads.update(position=cm.position.grad, look_at=cm.look_at.grad)
    for k, g in grads.items():
        require(g is not None and bool(torch.isfinite(g).all()),
                f"gradient of {k} missing or not finite")
    for k in ("center", "albedo", "position"):
        require(grads[k].abs().max().item() > 0, f"gradient of {k} is zero")
    main_grads = {k: g.clone() for k, g in grads.items()}
    for _ in range(2):
        t_step = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t_step)
    print(f"fwd+bwd main path: rtweekend {MAIN_W}x{MAIN_H} {MAIN_SPP} spp "
          f"fused+regen: {rays_g} rays; step {step_secs} s = "
          f"{[rays_g / t for t in step_secs]} rays/s on {card}; launches "
          f"{launches}; peak memory {peak} B above the "
          f"{mem0} B held before", flush=True)
    phase("fwd_bwd_main", t0)

    # 9. K2-record at the main path's own state (launches not counted):
    # the state it leaves must be the forward-only K2's bit for bit, and
    # on 1 lane in 32 its records must be the plain version's
    t0 = time.perf_counter()
    seg = min(SEG_MAX, steps)
    st_r = st0.clone()
    recs, k2r_ms = timed(torch, lambda: regen_record(st_r, c13, table, steps,
                                                     seg, sph=sph, **kwm))
    require(bits_equal(torch, st_r, st_k),
            "K2-record state differs from the forward-only K2's")
    # the recording sweep of every sphere, in turns with the culled one
    k2r_cull_ms, k2r_sweep_ms = [k2r_ms], []
    for _ in range(2):
        st_s = st0.clone()
        recs_w, ms = timed(torch, lambda: regen_record(
            st_s, c13, table, steps, seg, **kwm))
        k2r_sweep_ms.append(ms)
        require(bits_equal(torch, st_s, st_k) and torch.equal(
            recs_w.t_end, recs.t_end),
            "K2-record's sweep differs from the culled recording")
        del recs_w
        st_s = st0.clone()
        k2r_cull_ms.append(timed(torch, lambda: regen_record(
            st_s, c13, table, steps, seg, sph=sph, **kwm))[1])
    del st_s
    sl_r, sl_pr = st0[:, cols].contiguous(), st0[:, cols].contiguous()
    slr_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    recs_s, k2r_ms_slice = timed(torch, lambda: regen_record(
        sl_r, c13, table, steps, seg, sph=sph, stats=slr_stats, **kwm))
    require(torch.equal(slr_stats, sl_stats),
            "K2-record culled counts differ from the forward's")
    (_, recs_p), k2r_plain = timed(torch, lambda: regen_steps_plain(
        sl_pr, c13, table, steps, seg=seg, **kwm))
    require(bits_equal(torch, sl_r, sl_pr),
            "K2-record slice state not bit-equal to plain")
    require(torch.equal(recs_s.t_end, recs_p.t_end), "K2-record t_end")
    t_end_s = recs_p.t_end.long()
    valid = torch.arange(steps, device=dev)[:, None] < t_end_s[None, :]
    require(torch.equal(recs_s.rec[valid], recs_p.rec[valid]),
            "K2-record winner records differ from plain")
    for k in range(recs_p.chk.shape[0]):
        alive = t_end_s > k * seg
        require(bits_equal(torch, recs_s.chk[k][:, alive],
                           recs_p.chk[k][:, alive]),
                f"K2-record checkpoint {k} differs from plain")
    require(torch.equal(recs.t_end[cols], recs_s.t_end),
            "K2-record slice differs from the whole launch")
    n_chk = int(((recs.t_end.long() + seg - 1) // seg).sum())
    rec_bytes = 2 * rays + STATE_BYTES * n_chk + 4 * r2
    k2r_bound, k2r_by = bound(
        k2_pairs * FLOPS_PER_PAIR + k2_boxes * FLOPS_PER_BOX,
        k2_io + rec_bytes)
    kernels["regen_record"] = dict(
        name="regen_record", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:868",
        also_replaces="tpu_ray/kernels/regen.py:769",
        launches=launches["regen_record"], max_abs_err=0.0, ms=k2r_ms,
        plain_ms=k2r_plain, bound_ms=k2r_bound, bound_by=k2r_by,
        library_ms=None,
        path=f"main fwd+bwd: render_mean fused+regen {MAIN_W}x{MAIN_H} "
             f"{MAIN_SPP} spp",
        shape=f"{r2} lanes x {steps} steps, seg {seg}, {rays} rays, "
              f"{n_chk} lane checkpoints; culled sphere search, bound over "
              f"the pairs and boxes tested",
        forward_only_ms=k2_ms, plain_lanes=sl_pr.shape[1],
        ms_same_lanes=k2r_ms_slice, culled_ms=k2r_cull_ms,
        sweep_ms=k2r_sweep_ms,
        bound_every_sphere_ms=bound(rays * n_real * FLOPS_PER_PAIR,
                                    k2_io + rec_bytes)[0], **k2_sph)
    print(f"K2-record at the main path: {k2r_ms:.3f} ms against K2 "
          f"forward-only {k2_ms:.3f} ms (bound {k2r_bound:.3f} ms by "
          f"{k2r_by}); culled {k2r_cull_ms} ms against the sweep "
          f"{k2r_sweep_ms} ms in turns, the same state and t_end; "
          f"{k2_pairs} pairs tested, the counts on the slice equal to the "
          f"forward's; state bit-equal to forward-only; 1 lane in "
          f"{SLICE_STRIDE}: records, checkpoints and state equal to plain, "
          f"{k2r_ms_slice:.3f} ms kernel / {k2r_plain:.3f} ms plain",
          flush=True)
    phase("k2_record_check", t0)

    # 10. K3 at the main path's own records: the main loss's cotangent of
    # the colour total, the whole launch timed and repeated (the two
    # bit-equal: K3 sums in a fixed order); 1 lane in 32 held against the
    # plain version (d_state exactly; d_table and d_cam within 1e-4 of
    # each group's max of the plain version's f64 sum)
    t0 = time.perf_counter()
    col = st_k[16:19].T.contiguous().requires_grad_()
    image_mse(untile_image(col, MAIN_W, MAIN_H, inv)
              / torch.tensor(float(MAIN_SPP), device=dev), target).backward()
    d_out = torch.zeros_like(st0)
    d_out[16:19] = col.grad.T
    (d_st, d_tab, d_cam), k3_ms = timed(torch, lambda: regen_bwd(
        recs, d_out, c13, table, **kwm))
    again = regen_bwd(recs, d_out, c13, table, **kwm)
    require(all(bits_equal(torch, a, b) for a, b in zip((d_st, d_tab, d_cam),
                                                         again)),
            "K3: two launches on the main path's records differ")
    del again
    k3_info = regen_bwd_info(table.shape[0], dev)
    t_end_b = recs.t_end.long()

    def swept(block):
        """Lane-steps the blocks of `block` lanes sweep: each its lanes
        times its longest lane's alive steps."""
        pad = -t_end_b.shape[0] % block
        te = torch.cat([t_end_b, t_end_b.new_zeros(pad)]).view(-1, block)
        return int(te.amax(dim=1).sum()) * block

    k3_life = dict(alive_lane_steps=int(t_end_b.sum()),
                   swept_lane_steps=swept(k3_info["threads"]),
                   swept_lane_steps_256=swept(256))
    print(f"K3 launch 1: {k3_info} (registers and local bytes a thread, "
          f"blocks and warps an SM); lane-steps: {k3_life}", flush=True)
    scene_cols = dict(center=slice(0, 3), radius=3, albedo=slice(4, 7),
                      emissive=slice(7, 10), specular=10, ior=11)
    for k, c in scene_cols.items():
        want = main_grads[k][sperm]
        err = (d_tab[:, c] - want).abs().max().item()
        require(err <= 1e-4 * want.abs().max().item(),
                f"K3 d_table[{k}] differs from the fwd+bwd path's by {err}")
    recs_sl = type(recs)(recs.rec[:, cols].contiguous(),
                         recs.chk[:, :, cols].contiguous(),
                         recs.t_end[cols].contiguous(), seg)
    d_out_s = d_out[:, cols].contiguous()
    (k_st, k_tab, k_cam), k3_ms_slice = timed(torch, lambda: regen_bwd(
        recs_sl, d_out_s, c13, table, **kwm))
    (p_st, p_tab, p_cam), k3_plain = timed(torch, lambda: regen_bwd_plain(
        recs_sl, d_out_s, c13, table, **kwm))
    rows = list(range(12)) + [16, 17, 18]
    require(torch.equal(k_st, d_st[:, cols]),
            "K3 on the lane slice differs from the whole launch")
    st_err = (k_st[rows] - p_st[rows]).abs().max().item()
    require(torch.equal(k_st[rows], p_st[rows]),
            f"K3 d_state differs from plain by {st_err}")
    st_bits = bits_equal(torch, k_st[rows], p_st[rows])
    k3_err = 0.0
    groups = [(f"table.{k}", k_tab[:, c], p_tab[:, c])
              for k, c in scene_cols.items()]
    groups += [(f"cam[{a}:{a + 3}]", k_cam[a:a + 3], p_cam[a:a + 3])
               for a in (0, 3, 6, 9)]
    for name, a, b in groups:
        err = (a - b).abs().max().item()
        k3_err = max(k3_err, err)
        require(err <= 1e-4 * b.abs().max().item(),
                f"K3 {name} differs from plain by {err}")
    t_end_l = recs.t_end.long()
    k3_bound, k3_by = bound(
        rays * K3_FLOPS_PER_STEP,
        2 * rays + STATE_BYTES * n_chk + 4 * r2 + 15 * 4 * r2
        + STATE_BYTES * r2 + 2 * 48 * n_real + 52)
    kernels["regen_bwd"] = dict(
        name="regen_bwd", route="cuda",
        source="tpu_ray_torch/csrc/regen_bwd.cu",
        replaces="tpu_ray/kernels/regen.py:967",
        launches=launches["regen_bwd"], max_abs_err=k3_err, ms=k3_ms,
        plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by,
        library_ms=None,
        path=f"main fwd+bwd: render_mean fused+regen {MAIN_W}x{MAIN_H} "
             f"{MAIN_SPP} spp",
        shape=f"{r2} lanes, {int(t_end_l.sum())} alive lane-steps, seg "
              f"{seg}", plain_lanes=recs_sl.t_end.shape[0],
        ms_same_lanes=k3_ms_slice,
        stash_bytes=2 * 48 * int(t_end_l.sum()), **k3_info, **k3_life)
    print(f"K3 at the main path: {k3_ms:.3f} ms (bound {k3_bound:.3f} ms "
          f"by {k3_by}); two launches bit-equal; d_table equal to the "
          f"fwd+bwd path's within 1e-4; "
          f"1 lane in {SLICE_STRIDE}: d_state equal to plain (bit-equal "
          f"{st_bits}), d_table and "
          f"d_cam within 1e-4 of each group's max (max |d| {k3_err}), "
          f"{k3_ms_slice:.3f} ms kernel / {k3_plain:.3f} ms plain",
          flush=True)
    phase("k3_check", t0)
    del recs, recs_s, recs_p, recs_sl, st_r

    # 11. fused+regen gradients against backend torch autograd, and the
    # per-sample fused route's (K4/K5/K6) against fused+regen's, at
    # 320x180, 4 spp on the card: each group within 3e-3 of its max
    t0 = time.perf_counter()
    small, k11_small = {}, {}
    for route, backend, regen in (("fused", "fused", True),
                                  ("torch", "torch", False),
                                  ("sample", "fused", False)):
        k11_before = gather_rows_bwd.launches
        s2 = trainable_scene(scene)
        c2 = trainable_camera(tracer.camera)
        img2 = render_mean(s2, c2, width=CHECK_W, height=CHECK_H,
                           spp=CHECK_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                           backend=backend, regen=regen)
        image_mse(img2, torch.zeros_like(img2)).backward()
        k11_small[route] = gather_rows_bwd.launches - k11_before
        small[route] = [getattr(s2, k).grad for k in SCENE_LEAVES] + [
            c2.position.grad, c2.look_at.grad]
    small_err, sample_err = 0.0, 0.0
    for k, a, b, c in zip(SCENE_LEAVES + ("position", "look_at"),
                          small["fused"], small["torch"], small["sample"]):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
        small_err = max(small_err, rel)
        require(rel < 3e-3, f"fused grad {k} differs from torch by {rel}")
        rel = ((c - a).abs().max() / a.abs().max().clamp_min(1e-12)).item()
        sample_err = max(sample_err, rel)
        require(rel < 3e-3,
                f"per-sample grad {k} differs from fused+regen by {rel}")
    print(f"fused+regen vs torch autograd gradients, {CHECK_W}x{CHECK_H} "
          f"{CHECK_SPP} spp: max relative {small_err}; per-sample fused vs "
          f"fused+regen: max relative {sample_err}", flush=True)
    phase("grad_routes_check", t0)

    # 12. two make_train_step steps at the main path's size (the first
    # also pays the optimizer's one-time set-up)
    t0 = time.perf_counter()
    init_fn, step_fn = make_train_step(
        width=MAIN_W, height=MAIN_H, spp=MAIN_SPP, seed=SEED,
        max_bounces=MAX_BOUNCES, backend="fused", regen=True)
    state = init_fn(scene, tracer.camera)
    train_secs = []
    for _ in range(2):
        t_step = time.perf_counter()
        state, loss = step_fn(state, target)
        loss = loss.item()
        train_secs.append(time.perf_counter() - t_step)
    require(math.isfinite(loss) and state.step == 2, "train step")
    moved = (state.scene.albedo - scene.albedo).abs().max().item()
    require(moved > 0, "train step left the albedo unchanged")
    print(f"train steps: {train_secs} s, loss {loss}, max |d albedo| "
          f"{moved}", flush=True)
    phase("train_step", t0)
    del state, init_fn, step_fn

    # 13. K4, K5 and K6 at the per-sample route's own inputs: the main
    # camera's sample 0 on 1 lane in 32 of the tile-ordered pixels, bounce
    # after bounce (launches not counted). K4 bit-equal to plain: culled by
    # the Morton sphere tiles as the route runs it (its counters the plain
    # mirror's), by the host masks (the primary mask at bounce 0, the
    # octant mask after) and not culled; K5 bit-equal to K4; K6's d_state
    # equal to plain, d_table within 1e-4 of each group's max of the plain
    # f64 sum, two launches bit-equal
    t0 = time.perf_counter()
    ftb = fused_tables(scene, origin_bound(tracer.camera.position[None]))
    scene_p = permute_spheres(scene, morton_perm(scene))
    use_sky = scene.use_sky
    px_sl = torch.as_tensor(perm[::SLICE_STRIDE].copy(), device=dev)
    st = init_state(*camera_rays(tracer.camera, MAIN_W, MAIN_H, px_sl, 0,
                                 SEED))
    slice_ms = {"bounce_fwd": [0.0, 0.0], "bounce_replay": [0.0, 0.0],
                "bounce_bwd": [0.0, 0.0],      # kernel, plain
                "bounce_fwd_unculled": [0.0, 0.0]}
    sl_k4_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    sl_k4_mirror = torch.zeros_like(sl_k4_stats)
    states, idxs = [], []
    for b in range(MAX_BOUNCES):
        mask = (bounce_cull_mask if b == 0 else bounce_cull_mask_octant)(
            scene_p, st)
        (out_k, idx_k), _, by_key, _ = profiled(torch, lambda: bounce_fwd(
            st, ftb.table, b, use_sky=use_sky, sph=ftb.sph,
            stats=sl_k4_stats))
        ms_k = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd"])
        (out_p, idx_p), ms_p = timed(torch, lambda: bounce_fwd_plain(
            st, ftb.table, b, use_sky=use_sky, sph=ftb.sph,
            stats=sl_k4_mirror))
        (out_ku, idx_ku), _, by_key, _ = profiled(torch, lambda: bounce_fwd(
            st, ftb.table, b, use_sky=use_sky))
        ms_ku = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd"])
        (out_pu, idx_pu), ms_pu = timed(torch, lambda: bounce_fwd_plain(
            st, ftb.table, b, use_sky=use_sky))
        out_kc, idx_kc = bounce_fwd(st, ftb.table, b, mask, use_sky=use_sky)
        out_pc, idx_pc = bounce_fwd_plain(st, ftb.table, b, mask,
                                          use_sky=use_sky)
        torch.cuda.synchronize()
        for name, o_, i_ in (("plain", out_p, idx_p), ("unculled", out_ku,
                                                         idx_ku),
                             ("plain unculled", out_pu, idx_pu),
                             ("masked", out_kc, idx_kc),
                             ("plain masked", out_pc, idx_pc)):
            require(torch.equal(i_, idx_k) and bits_equal(torch, o_, out_k),
                    f"K4 bounce {b}: {name} differs from the kernel")
        require(torch.equal(sl_k4_stats, sl_k4_mirror),
                f"K4 culled counts {sl_k4_stats.tolist()} differ from the "
                f"plain mirror's {sl_k4_mirror.tolist()}")
        slice_ms["bounce_fwd_unculled"][0] += ms_ku
        slice_ms["bounce_fwd_unculled"][1] += ms_pu
        rep, _, by_key, _ = profiled(torch, lambda: bounce_replay(
            st, ftb.table, idx_k, b, use_sky=use_sky))
        ms_rk = kernel_ms(by_key, BOUNCE_KERNELS["bounce_replay"])
        rep_p, ms_rp = timed(torch, lambda: bounce_replay_plain(
            st, ftb.table, idx_k, b, use_sky=use_sky))
        require(bits_equal(torch, rep, out_k) and bits_equal(torch, rep_p,
                                                             out_k),
                f"K5 bounce {b}: not K4's state bit for bit")
        slice_ms["bounce_fwd"][0] += ms_k
        slice_ms["bounce_fwd"][1] += ms_p
        if b < MAX_BOUNCES - 1:       # the backward replays B-1 bounces
            slice_ms["bounce_replay"][0] += ms_rk
            slice_ms["bounce_replay"][1] += ms_rp
        states.append(st)
        idxs.append(idx_k)
        st = out_k
    d = torch.zeros_like(st)
    d[9:12] = st[9:12]                # the cotangent of sum(color^2) / 2
    k6_err = 0.0
    for b in reversed(range(MAX_BOUNCES)):
        d_in = d.clone()
        (d_k, tab_k), _, by_key, _ = profiled(torch, lambda: bounce_bwd(
            states[b], ftb.table, idxs[b], b, d_in, use_sky=use_sky))
        ms_k = kernel_ms(by_key, BOUNCE_KERNELS["bounce_bwd"])
        d_k2, tab_k2 = bounce_bwd(states[b], ftb.table, idxs[b], b,
                                  d.clone(), use_sky=use_sky)
        (d_p, tab_p), ms_p = timed(torch, lambda: bounce_bwd_plain(
            states[b], ftb.table, idxs[b], b, d.clone(), use_sky=use_sky))
        require(torch.equal(d_k, d_p), f"K6 bounce {b}: d_state differs "
                f"from plain by {(d_k - d_p).abs().max().item()}")
        require(bits_equal(torch, d_k, d_k2) and bits_equal(torch, tab_k,
                                                            tab_k2),
                f"K6 bounce {b}: two launches differ")
        for c in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                  slice(10, 11), slice(11, 12)):
            err = (tab_k[:, c] - tab_p[:, c]).abs().max().item()
            k6_err = max(k6_err, err)
            require(err <= 1e-4 * tab_p[:, c].abs().max().item(),
                    f"K6 bounce {b}: d_table[:, {c}] differs by {err}")
        slice_ms["bounce_bwd"][0] += ms_k
        slice_ms["bounce_bwd"][1] += ms_p
        d = d_k
    n_sl = px_sl.shape[0]
    print(f"K4/K5/K6 at the per-sample route's inputs, 1 lane in "
          f"{SLICE_STRIDE} ({n_sl} lanes), sample 0: K4 culled by the "
          f"sphere tiles bit-equal to plain, unculled and masked (counts: "
          f"{sl_k4_stats.tolist()} boxes, tiles, pairs tested, the plain "
          f"mirror's), K5 bit-equal to K4, K6 d_state equal to "
          f"plain and d_table within 1e-4 (max |d| {k6_err}), two K6 "
          f"launches bit-equal; kernel / plain ms {slice_ms}", flush=True)
    del states, idxs, st, d, out_k, out_p, out_kc, out_pc, rep, rep_p
    del out_ku, out_pu

    # the same at the route's full width, sample 0: all 2,073,600 lanes,
    # so each of K6's blocks sums some 32 lane tiles into its partials
    # (the slice is one tile a block). K4 culled as on the route, equal
    # to unculled (and to the octant mask after bounce 0); K5 bit-equal
    # to K4; K6 against its plain version as above
    px_all = torch.as_tensor(perm, device=dev)
    st = init_state(*camera_rays(tracer.camera, MAIN_W, MAIN_H, px_all, 0,
                                 SEED))
    states, idxs = [], []
    for b in range(MAX_BOUNCES):
        masks = [None, (bounce_cull_mask if b == 0 else
                        bounce_cull_mask_octant)(scene_p, st)]
        out_k, idx_k = bounce_fwd(st, ftb.table, b, use_sky=use_sky,
                                  sph=ftb.sph)
        for mask in masks:
            out_m, idx_m = bounce_fwd(st, ftb.table, b, mask,
                                      use_sky=use_sky)
            require(torch.equal(idx_m, idx_k) and bits_equal(torch, out_m,
                                                             out_k),
                    f"K4 full width, bounce {b}: culled differs")
        rep = bounce_replay(st, ftb.table, idx_k, b, use_sky=use_sky)
        require(bits_equal(torch, rep, out_k),
                f"K5 full width, bounce {b}: not K4's state bit for bit")
        states.append(st)
        idxs.append(idx_k)
        st = out_k
    del out_m, rep
    d = torch.zeros_like(st)
    d[9:12] = st[9:12]
    k6_full_err, k6_full_rel = 0.0, 0.0
    for b in reversed(range(MAX_BOUNCES)):
        d_k, tab_k = bounce_bwd(states[b], ftb.table, idxs[b], b, d.clone(),
                                use_sky=use_sky)
        d_k2, tab_k2 = bounce_bwd(states[b], ftb.table, idxs[b], b,
                                  d.clone(), use_sky=use_sky)
        d_p, tab_p = bounce_bwd_plain(states[b], ftb.table, idxs[b], b,
                                      d.clone(), use_sky=use_sky)
        require(torch.equal(d_k, d_p), f"K6 full width, bounce {b}: d_state "
                f"differs from plain by {(d_k - d_p).abs().max().item()}")
        require(bits_equal(torch, d_k, d_k2) and bits_equal(torch, tab_k,
                                                            tab_k2),
                f"K6 full width, bounce {b}: two launches differ")
        for c in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                  slice(10, 11), slice(11, 12)):
            err = (tab_k[:, c] - tab_p[:, c]).abs().max().item()
            top = tab_p[:, c].abs().max().item()
            k6_full_err = max(k6_full_err, err)
            k6_full_rel = max(k6_full_rel, err / max(top, 1e-30))
            require(err <= 1e-4 * top,
                    f"K6 full width, bounce {b}: d_table[:, {c}] differs "
                    f"by {err}")
        d = d_k
    k6_err = max(k6_err, k6_full_err)
    k6_parts = build.load().trt_bounce_bwd_parts(px_all.shape[0],
                                                 ftb.table.shape[0])
    print(f"K4/K5/K6 at the per-sample route's full width, sample 0 "
          f"({px_all.shape[0]} lanes, {k6_parts} K6 blocks): K4 culled "
          f"equal to unculled and masked, K5 "
          f"bit-equal to K4, K6 d_state equal to plain and d_table within "
          f"1e-4 (max |d| {k6_full_err}, {k6_full_rel} of its group's "
          f"max), two K6 launches bit-equal",
          flush=True)
    phase("k4k5k6_check", t0)
    del states, idxs, st, d, d_k, d_k2, d_p, out_k

    # 14. the per-sample fused route's forward pass as the CLI drives it
    # (render --backend fused --no-regen), two calls; then one more under
    # torch.profiler (CUDA events around a launch would also count the
    # host's time to issue it: this route is bound by the host)
    t0 = time.perf_counter()
    cfg_s = RenderConfig(scene="rtweekend", width=MAIN_W, height=MAIN_H,
                         spp=MAIN_SPP, max_bounces=MAX_BOUNCES,
                         backend="fused", seed=SEED, regen=False)
    tracer_s = PathTracer(cfg_s, scene=scene, device=dev)
    fwd_secs = []
    for _ in range(2):
        state0 = tracer_s.init_state()
        torch.cuda.synchronize()
        reset_counts()
        t_main = time.perf_counter()
        state_s, rays_s = tracer_s.step(state0)
        torch.cuda.synchronize()
        fwd_secs.append(time.perf_counter() - t_main)
        k4_launches = bounce_fwd.launches
        require(k4_launches == MAIN_SPP * MAX_BOUNCES,
                f"per-sample forward launched K4 {k4_launches} times")
        require(bounce_fwd.culled_launches == k4_launches,
                "per-sample forward did not take K4's culled sphere search")
        require(sum(counts().values()) == k4_launches,
                f"per-sample forward launched others: {counts()}")
    mean_s = state_s.mean
    require(rays_s == rays,
            f"per-sample rays {rays_s} != fused+regen's {rays}")
    require(bool(torch.isfinite(mean_s).all()) and
            tuple(mean_s.shape) == (MAIN_H, MAIN_W, 3), "per-sample image")
    # both routes run on the Morton-permuted scene, so an exact tie in t
    # goes to the same sphere on both: the images must be equal bit for bit
    img_d = (mean_s - mean).abs()
    require(torch.equal(mean_s, mean),
            f"per-sample image differs from fused+regen's on "
            f"{int((img_d > 0).any(-1).sum())} pixels, max {img_d.max()}")
    print(f"per-sample forward: rtweekend {MAIN_W}x{MAIN_H} {MAIN_SPP} spp "
          f"fused --no-regen: {rays_s} rays (= fused+regen) in {fwd_secs} s "
          f"= {[rays_s / t for t in fwd_secs]} rays/s on {card}; K4 launches "
          f"{k4_launches}; image bit-equal to fused+regen's", flush=True)
    # the work of this pass's K4, K5 and K6 launches on this run's data,
    # counted outside the profiled calls: the route's bounces of every
    # sample again, K4 with its counters on (the sphere pairs and tile
    # boxes its culled search tested) and on 1 lane in 32 of every
    # bounce's input state held bit for bit against its plain version,
    # the counters against the plain mirror's; beside them every real
    # sphere of each alive lane (the bound of a search without the cull);
    # and the live lanes that K5 (bounces 0..B-2) and K6 (all) shade
    work = {n: [0.0, 0.0, 0] for n in ("bounce_fwd", "bounce_replay",
                                       "bounce_bwd")}   # flops, bytes, n
    tab_bytes = ftb.table.numel() * 4
    sph_bytes = 4 * sum(t.numel() for t in (ftb.sph.boxes, ftb.sph.starts,
                                            ftb.sph.gboxes, ftb.sph.gstarts))
    k4_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    k4_sl_stats = torch.zeros_like(k4_stats)
    k4_sl_mirror = torch.zeros_like(k4_stats)
    k4_sl_ms = [0.0, 0.0]             # kernel, plain on the slices
    acc_rays = every_flops = 0
    with torch.no_grad():
        for k in range(MAIN_SPP):
            st = init_state(*camera_rays(tracer_s.camera, MAIN_W, MAIN_H,
                                         px_all, k, SEED))
            for b in range(MAX_BOUNCES):
                n_alive = (st[12] > 0.5).sum()
                acc_rays = acc_rays + n_alive
                every_flops = (every_flops + n_alive.double() * n_real
                               * FLOPS_PER_PAIR)
                sl = st[:, cols].contiguous()
                nbytes = ((2 * BOUNCE_STATE_BYTES + 4) * st.shape[1]
                          + tab_bytes + sph_bytes)
                st, idx = bounce_fwd(st, ftb.table, b, use_sky=use_sky,
                                     sph=ftb.sph, stats=k4_stats)
                (out_s, idx_s), ms_k = timed(torch, lambda: bounce_fwd(
                    sl, ftb.table, b, use_sky=use_sky, sph=ftb.sph,
                    stats=k4_sl_stats))
                (out_p, idx_p), ms_p = timed(torch, lambda: bounce_fwd_plain(
                    sl, ftb.table, b, use_sky=use_sky, sph=ftb.sph,
                    stats=k4_sl_mirror))
                require(torch.equal(idx_s, idx_p)
                        and bits_equal(torch, out_s, out_p)
                        and torch.equal(idx_s, idx[cols])
                        and bits_equal(torch, out_s,
                                       st[:, cols].contiguous()),
                        f"K4 culled, sample {k} bounce {b}: 1 lane in "
                        f"{SLICE_STRIDE} differs from plain or the launch")
                k4_sl_ms[0] += ms_k
                k4_sl_ms[1] += ms_p
                live = (idx >= 0).double().sum()
                todo = [("bounce_fwd", 0.0, nbytes),
                        ("bounce_bwd", live * K6_FLOPS_PER_LANE,
                         K6_LANE_BYTES * st.shape[1] + 2 * tab_bytes)]
                if b < MAX_BOUNCES - 1:
                    todo.append(("bounce_replay", live * K5_FLOPS_PER_LANE,
                                 (2 * BOUNCE_STATE_BYTES + 4) * st.shape[1]
                                 + tab_bytes))
                for n, f_, b_ in todo:
                    work[n][0] = work[n][0] + f_
                    work[n][1] += b_
                    work[n][2] += 1
    require(int(acc_rays) == rays_s,
            f"the bounds' bounce loop cast {int(acc_rays)} rays, the route "
            f"{rays_s}")
    require(torch.equal(k4_sl_stats, k4_sl_mirror),
            f"K4 culled counts on the slices {k4_sl_stats.tolist()} differ "
            f"from the plain mirror's {k4_sl_mirror.tolist()}")
    k4_boxes, k4_folded, k4_pairs = k4_stats.tolist()
    work["bounce_fwd"][0] = (k4_pairs * FLOPS_PER_PAIR
                             + k4_boxes * FLOPS_PER_BOX)
    k4_bound_all = bound(float(every_flops), work["bounce_fwd"][1])[0]
    work = {n: (int(w[2]),) + bound(float(w[0]), float(w[1]))
            for n, w in work.items()}
    del out_s, out_p, sl

    # K4 culled against the search it replaced, in turns in this call:
    # the pass's K4 launches as the route makes them (every sample's
    # raygen, then its bounces) with the sphere tiles, and with the host's
    # primary cull mask at bounce 0 and no mask after (the route before the
    # cull; its tile boxes taken once, as the route took them); culled,
    # host mask, host mask, culled
    mask_lo, mask_hi = tile_bounds(scene_p)

    def k4_pass(culled):
        """-> (wall s to a synchronize, K4 ms by CUDA events summed over
        the launches, the samples' colours summed)."""
        evs = []
        col = torch.zeros((3, px_all.shape[0]), device=dev)
        torch.cuda.synchronize()
        t_p = time.perf_counter()
        with torch.no_grad():
            for k in range(MAIN_SPP):
                st = init_state(*camera_rays(tracer_s.camera, MAIN_W,
                                             MAIN_H, px_all, k, SEED))
                for b in range(MAX_BOUNCES):
                    mask = None
                    if not culled and b == 0:
                        mask = cull_mask(*ray_block_bounds(st), mask_lo,
                                         mask_hi)
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    st, _ = bounce_fwd(st, ftb.table, b, mask,
                                       use_sky=use_sky,
                                       sph=ftb.sph if culled else None)
                    ev[1].record()
                    evs.append(ev)
                col += st[9:12]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_p
        return wall, sum(a.elapsed_time(e) for a, e in evs), col

    k4_turns = {True: [], False: []}
    col_ref = None
    for culled in (True, False, False, True):
        wall, ms, col = k4_pass(culled)
        k4_turns[culled].append((wall, ms))
        col_ref = col if col_ref is None else col_ref
        require(bits_equal(torch, col, col_ref),
                "K4 culled and host-masked passes end in other colours")
    del col, col_ref
    print(f"K4 over the per-sample rtweekend pass: {k4_launches} launches "
          f"culled by {ftb.sph.boxes.shape[0]} sphere tiles: "
          f"{k4_boxes} boxes tested, {k4_folded} tiles folded, {k4_pairs} "
          f"ray-sphere pairs tested of {rays_s * n_real} "
          f"({k4_pairs / (rays_s * n_real):.4f}); bound "
          f"{work['bounce_fwd'][1]:.3f} ms by {work['bounce_fwd'][2]} over "
          f"what it tested, {k4_bound_all:.3f} ms over every sphere; in "
          f"turns (wall s, K4 ms by CUDA events): culled "
          f"{k4_turns[True]}, host mask at bounce 0 and none after "
          f"{k4_turns[False]}, the same colours; 1 lane in {SLICE_STRIDE} "
          f"of all {MAIN_SPP * MAX_BOUNCES} bounces bit-equal to plain, "
          f"counts {k4_sl_stats.tolist()} the plain mirror's, "
          f"{k4_sl_ms[0]:.3f} ms kernel / {k4_sl_ms[1]:.3f} ms plain",
          flush=True)
    del st, idx
    before = counts()
    (state_t, _), fwd_prof_secs, by_key, busy = profiled(
        torch, lambda: tracer_s.step(tracer_s.init_state()))
    require(counts()["bounce_fwd"] - before["bounce_fwd"]
            == work["bounce_fwd"][0], "the profiled pass launched K4 "
            "another number of times than the bounds count")
    k4_keys = [k for k in by_key if "bounce_fwd_kernel" in k]
    require(k4_keys and not any("<true>" in k for k in k4_keys),
            f"the profiled pass's K4 was not the sphere mode: {k4_keys}")
    require(torch.equal(state_t.mean, mean_s), "profiled pass image differs")
    k4_ms = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd"])
    require(k4_ms > 0, "torch.profiler recorded no K4 device time")
    k4_bound = work["bounce_fwd"][1:]
    fwd_idle = 1.0 - busy / 1e3 / fwd_prof_secs
    print(f"per-sample forward under torch.profiler: {fwd_prof_secs:.3f} s "
          f"wall, device busy {busy:.3f} ms (idle share {fwd_idle:.3f}); "
          f"K4 {k4_ms:.3f} ms over {work['bounce_fwd'][0]} launches "
          f"(bound {k4_bound[0]:.3f} ms by {k4_bound[1]})", flush=True)
    phase("sample_forward", t0)

    # 15. the per-sample route's forward+backward, as a user
    # differentiates it: image_mse(render_mean(..., regen=False), 0)
    # .backward() w.r.t. every scene leaf and the camera, three calls; then
    # one more under torch.profiler
    t0 = time.perf_counter()

    def fwd_bwd_sample():
        for leaf in leaves:
            leaf.grad = None
        img_g, rays_g = render_mean(sc, cm, width=MAIN_W, height=MAIN_H,
                                    spp=MAIN_SPP, seed=SEED,
                                    max_bounces=MAX_BOUNCES, backend="fused",
                                    regen=False, return_rays=True)
        image_mse(img_g, target).backward()
        return img_g.detach(), rays_g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0_s = torch.cuda.memory_allocated()
    reset_counts()
    sample_secs = []
    t_step = time.perf_counter()
    img_s, rays_sg = fwd_bwd_sample()
    torch.cuda.synchronize()
    sample_secs.append(time.perf_counter() - t_step)
    launches_s = counts()
    peak_s = torch.cuda.max_memory_allocated() - mem0_s
    require(launches_s["bounce_fwd"] == MAIN_SPP * MAX_BOUNCES
            and launches_s["bounce_replay"] == MAIN_SPP * (MAX_BOUNCES - 1)
            and launches_s["bounce_bwd"] == MAIN_SPP * MAX_BOUNCES,
            f"per-sample fwd+bwd launches {launches_s}")
    require(bounce_fwd.culled_launches == launches_s["bounce_fwd"],
            "per-sample fwd+bwd did not take K4's culled sphere search")
    require(sum(launches_s.values()) == launches_s["bounce_fwd"]
            + launches_s["bounce_replay"] + launches_s["bounce_bwd"],
            f"per-sample fwd+bwd launched other kernels: {launches_s}")
    require(rays_sg == rays, f"per-sample fwd+bwd rays {rays_sg} != {rays}")
    require(torch.equal(img_s, mean_s),
            "per-sample fwd+bwd image differs from its forward pass")
    grads_s = {k: getattr(sc, k).grad for k in SCENE_LEAVES}
    grads_s.update(position=cm.position.grad, look_at=cm.look_at.grad)
    for k, g in grads_s.items():
        require(g is not None and bool(torch.isfinite(g).all()),
                f"per-sample gradient of {k} missing or not finite")
    for k in ("center", "albedo", "position"):
        require(grads_s[k].abs().max().item() > 0,
                f"per-sample gradient of {k} is zero")
    for _ in range(2):
        t_step = time.perf_counter()
        fwd_bwd_sample()
        torch.cuda.synchronize()
        sample_secs.append(time.perf_counter() - t_step)
    print(f"per-sample fwd+bwd: rtweekend {MAIN_W}x{MAIN_H} {MAIN_SPP} spp "
          f"fused --no-regen: {rays_sg} rays; step {sample_secs} s = "
          f"{[rays_sg / t for t in sample_secs]} rays/s on {card}; launches "
          f"{launches_s}; peak memory {peak_s} B above the {mem0_s} B held "
          f"before", flush=True)

    before = counts()
    (img_t, _), step_prof_secs, by_key, busy = profiled(torch,
                                                        fwd_bwd_sample)
    require(all(counts()[n] - before[n] == w[0] for n, w in work.items()),
            "the profiled step's launches differ from the bounds' count")
    require(torch.equal(img_t, mean_s), "profiled step image differs")
    step_tot = {n: (kernel_ms(by_key, BOUNCE_KERNELS[n]),) + w
                for n, w in work.items()}
    step_idle = 1.0 - busy / 1e3 / step_prof_secs
    require(all(v[0] > 0 for v in step_tot.values()),
            f"torch.profiler recorded no device time: {step_tot}")
    print(f"per-sample fwd+bwd under torch.profiler: {step_prof_secs:.3f} s "
          f"wall, device busy {busy:.3f} ms (idle share {step_idle:.3f}); "
          + "; ".join(f"{n} {v[0]:.3f} ms over {v[1]} launches (bound "
                      f"{v[2]:.3f} ms by {v[3]})"
                      for n, v in step_tot.items()), flush=True)
    phase("sample_fwd_bwd", t0)

    path_s = (f"per-sample: render fused --no-regen {MAIN_W}x{MAIN_H} "
              f"{MAIN_SPP} spp")
    path_sg = (f"per-sample fwd+bwd: render_mean fused --no-regen "
               f"{MAIN_W}x{MAIN_H} {MAIN_SPP} spp")
    k5_step, k6_step = step_tot["bounce_replay"], step_tot["bounce_bwd"]
    kernels["bounce_fwd"] = dict(
        name="bounce_fwd", route="cuda", source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1548",
        launches=k4_launches, max_abs_err=0.0, ms=k4_ms,
        plain_ms=slice_ms["bounce_fwd"][1], bound_ms=k4_bound[0],
        bound_by=k4_bound[1], library_ms=None, path=path_s,
        shape=f"{MAIN_SPP * MAX_BOUNCES} launches of {r2} lanes x "
              f"{scene.n_pad} spheres ({n_real} real) culled by "
              f"{ftb.sph.boxes.shape[0]} sphere tiles; ms and bound: the "
              f"whole pass, the bound over the pairs and boxes tested",
        plain_lanes=n_sl, ms_same_lanes=slice_ms["bounce_fwd"][0],
        same_lanes="sample 0, 5 bounces", culled_launches=k4_launches,
        bound_every_sphere_ms=k4_bound_all, tile_boxes_tested=k4_boxes,
        tiles_folded=k4_folded, pairs_tested=k4_pairs,
        pairs_every_sphere=rays_s * n_real,
        culled_turns_s_ms=k4_turns[True],
        host_mask_turns_s_ms=k4_turns[False],
        unculled_ms_same_lanes=slice_ms["bounce_fwd_unculled"][0],
        unculled_plain_ms=slice_ms["bounce_fwd_unculled"][1],
        all_bounces_ms_same_lanes=k4_sl_ms[0],
        all_bounces_plain_ms=k4_sl_ms[1])
    kernels["bounce_replay"] = dict(
        name="bounce_replay", route="cuda",
        source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1871",
        launches=launches_s["bounce_replay"], max_abs_err=0.0,
        ms=k5_step[0], plain_ms=slice_ms["bounce_replay"][1],
        bound_ms=k5_step[2], bound_by=k5_step[3], library_ms=None,
        path=path_sg,
        shape=f"{k5_step[1]} launches of {r2} lanes; ms and bound: one step",
        plain_lanes=n_sl, ms_same_lanes=slice_ms["bounce_replay"][0],
        same_lanes="sample 0, 4 bounces")
    kernels["bounce_bwd"] = dict(
        name="bounce_bwd", route="cuda", source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1901",
        launches=launches_s["bounce_bwd"], max_abs_err=k6_err,
        ms=k6_step[0], plain_ms=slice_ms["bounce_bwd"][1],
        bound_ms=k6_step[2], bound_by=k6_step[3], library_ms=None,
        path=path_sg,
        shape=f"{k6_step[1]} launches of {r2} lanes; ms and bound: one step",
        plain_lanes=n_sl, ms_same_lanes=slice_ms["bounce_bwd"][0],
        same_lanes="sample 0, 5 bounces",
        k4_ms_in_step=step_tot["bounce_fwd"][0])

    # 16. K7 at its path's inputs: trimesh's primary rays at 320x180 (one
    # sample: 57,600 rays x 10,368 triangles) bit-equal to the plain
    # version on every lane, and the path itself: backend cuda's render of
    # trimesh (K1 for the sphere, K7 for the triangles, in the eager bounce
    # loop) at 320x180, 4 spp, bit-equal to backend torch's; then trimesh's
    # 1920x1080 primary rays (2,073,600), bit-equal to the plain version on
    # 1 lane in 32. K7's time by CUDA events at both ray counts, beside the
    # triangle slices it chose; K1 on this path: its device time over one
    # more render under torch.profiler and a launch on the primary rays
    t0 = time.perf_counter()
    tscene = make_scene("trimesh", device=dev)
    tcam = default_camera(tscene)
    n_tri_real = tscene.tris.n_real
    n_sph_real = int((tscene.radius > 0).sum())
    torch.cuda.synchronize()
    reset_counts()
    img_c, rays_c = render_pass(tscene, tcam, width=CHECK_W, height=CHECK_H,
                                spp=CHECK_SPP, backend="cuda", seed=SEED)
    torch.cuda.synchronize()
    k7_launches = tri_nearest_hit.launches
    k1t_launches = sphere_nearest_hit.launches
    require(k7_launches > 0 and k1t_launches > 0,
            f"backend cuda on trimesh did not launch K1 and K7: {counts()}")
    require(sum(counts().values()) == k7_launches + k1t_launches,
            f"backend cuda on trimesh launched others: {counts()}")
    before = counts()
    (img_q, _), _, by_key_t, _ = profiled(torch, lambda: render_pass(
        tscene, tcam, width=CHECK_W, height=CHECK_H, spp=CHECK_SPP,
        backend="cuda", seed=SEED))
    require(sphere_nearest_hit.launches - before["sphere_nearest_hit"]
            == k1t_launches and torch.equal(img_q, img_c),
            "the profiled backend cuda trimesh pass differs")
    img_p, rays_p = render_pass(tscene, tcam, width=CHECK_W, height=CHECK_H,
                                spp=CHECK_SPP, backend="torch", seed=SEED)
    require(rays_c == rays_p and torch.equal(img_c, img_p),
            f"backend cuda trimesh image differs from torch by max "
            f"{(img_c - img_p).abs().max().item()}")
    require(bool(torch.isfinite(img_c).all()) and img_c.mean().item() > 0,
            "backend cuda trimesh image is not finite and non-black")
    ttab = tri_search_table(tscene.tris)
    o1, d1, _ = camera_rays(tcam, CHECK_W, CHECK_H, torch.arange(
        CHECK_W * CHECK_H, device=dev), 0, SEED)
    k1_held(torch, tscene.center, tscene.radius, o1, d1,
            "trimesh primary rays")
    k1_paths["trimesh, backend cuda"] = k1_path(
        torch, tscene.center, tscene.radius, o1, d1, k1t_launches,
        kernel_ms(by_key_t, K1_NAMES),
        f"render backend=cuda trimesh {CHECK_W}x{CHECK_H} {CHECK_SPP} spp: "
        f"{k1t_launches} launches of {o1.shape[0]} rays x "
        f"{tscene.n_pad} slots")
    hk = tri_nearest_hit(ttab, o1, d1)
    hp = tri_hit_plain(ttab, o1, d1)
    torch.cuda.synchronize()
    require(torch.equal(hk.idx, hp.idx) and bits_equal(torch, hk.t, hp.t),
            "K7: primary-ray t or idx differ from plain")
    hit7 = hp.t < 1e29
    k7_err = (hk.t - hp.t)[hit7].abs().max().item() if hit7.any() else 0.0
    r7 = o1.shape[0]
    k7_ms = cuda_ms(torch, lambda: tri_nearest_hit(ttab, o1, d1), 10)
    k7_plain = cuda_ms(torch, lambda: tri_hit_plain(ttab, o1, d1), 2)
    k7_flops, k7_exits = mt_work(torch, ttab, o1, d1)
    k7_bound, k7_by = bound(k7_flops, r7 * 32 + n_tri_real * TRI_BYTES)
    k7_slices = tri_slices(r7, ttab.shape[0], dev)
    o_hd, d_hd, _ = camera_rays(tcam, MAIN_W, MAIN_H, torch.arange(
        MAIN_W * MAIN_H, device=dev), 0, SEED)
    r_hd = o_hd.shape[0]
    lanes_hd = torch.arange(0, r_hd, SLICE_STRIDE, device=dev)
    hk_hd = tri_nearest_hit(ttab, o_hd, d_hd)
    hp_hd, k7_plain_hd = timed(torch, lambda: tri_hit_plain(
        ttab, o_hd[lanes_hd], d_hd[lanes_hd]))
    require(torch.equal(hk_hd.idx[lanes_hd], hp_hd.idx)
            and bits_equal(torch, hk_hd.t[lanes_hd], hp_hd.t),
            f"K7: {MAIN_W}x{MAIN_H} primary rays differ from plain on 1 lane "
            f"in 32")
    k7_ms_hd = cuda_ms(torch, lambda: tri_nearest_hit(ttab, o_hd, d_hd), 3)
    k7_slices_hd = tri_slices(r_hd, ttab.shape[0], dev)
    f_hd, _ = mt_work(torch, ttab, o_hd[lanes_hd], d_hd[lanes_hd])
    k7_bound_hd = bound(f_hd * r_hd / lanes_hd.shape[0],
                        r_hd * 32 + n_tri_real * TRI_BYTES)
    kernels["tri_nearest_hit"] = dict(
        name="tri_nearest_hit", route="cuda",
        source="tpu_ray_torch/csrc/tri_intersect.cu",
        replaces="tpu_ray/kernels/tri_intersect.py:389",
        launches=k7_launches, max_abs_err=k7_err, ms=k7_ms,
        plain_ms=k7_plain, bound_ms=k7_bound, bound_by=k7_by,
        library_ms=None,
        path=f"render backend=cuda trimesh {CHECK_W}x{CHECK_H} "
             f"{CHECK_SPP} spp",
        shape=f"{r7} rays x {tscene.tris.n_pad} triangles ({n_tri_real} "
              f"real), {int(hit7.sum())} hits; ms: CUDA events",
        pairs_leaving_at=k7_exits, slices=k7_slices,
        ms_1080p=k7_ms_hd, slices_1080p=k7_slices_hd,
        bound_1080p_ms=k7_bound_hd[0], plain_ms_1080p_slice=k7_plain_hd,
        plain_lanes_1080p=int(lanes_hd.shape[0]))
    print(f"backend cuda, trimesh: {rays_c} rays, K7 launches {k7_launches},"
          f" image equal to backend torch; K7 at {r7} primary rays "
          f"bit-equal to plain: {k7_ms:.4f} ms in {k7_slices} triangle "
          f"slices (bound {k7_bound:.4f} ms by {k7_by}; pairs leaving the "
          f"test at {k7_exits}) / plain {k7_plain:.4f} ms; at {r_hd} primary "
          f"rays ({MAIN_W}x{MAIN_H}) bit-equal to plain on 1 lane in 32: "
          f"{k7_ms_hd:.3f} ms in {k7_slices_hd} slice(s) (bound "
          f"{k7_bound_hd[0]:.3f} ms by {k7_bound_hd[1]}) / plain "
          f"{k7_plain_hd:.1f} ms on the slice; on {card}; K1 on this path: "
          f"{k1_paths['trimesh, backend cuda']}", flush=True)
    phase("k7_check", t0)

    # 17. the triangle main path as the CLI drives it (render --scene
    # trimesh): 1920x1080, 2 spp, fused + regen, two calls
    t0 = time.perf_counter()
    cfg_t = RenderConfig(scene="trimesh", width=MAIN_W, height=MAIN_H,
                         spp=TRI_SPP, max_bounces=MAX_BOUNCES,
                         backend="fused", seed=SEED, regen=True)
    tracer_t = PathTracer(cfg_t, scene=tscene, device=dev)
    tri_secs = []
    for _ in range(2):
        state0 = tracer_t.init_state()
        torch.cuda.synchronize()
        reset_counts()
        t_main = time.perf_counter()
        state_t, rays_t = tracer_t.step(state0)
        torch.cuda.synchronize()
        tri_secs.append(time.perf_counter() - t_main)
        k2t_launches = regen_steps.launches
        require(k2t_launches > 0, "triangle main path did not launch K2")
        require(regen_steps.listed_launches == k2t_launches,
                "triangle main path did not take K2's listed mode")
        require(sum(counts().values()) == k2t_launches,
                f"triangle forward path launched others: {counts()}")
    mean_t = state_t.mean
    require(tuple(mean_t.shape) == (MAIN_H, MAIN_W, 3), "trimesh shape")
    require(bool(torch.isfinite(mean_t).all()), "trimesh image not finite")
    require(mean_t.mean().item() > 0.01, "trimesh image is black")
    n_s = TRI_SPP * MAIN_W * MAIN_H
    require(n_s <= rays_t <= n_s * MAX_BOUNCES,
            f"trimesh rays {rays_t} out of range")
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "trimesh.png")
        write_png(png, tracer_t.srgb_image(state_t).cpu().numpy())
        png_bytes = os.path.getsize(png)
    print(f"triangle main path: trimesh ({n_tri_real} triangles) "
          f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp fused+regen: {rays_t} rays in "
          f"{tri_secs} s = {[rays_t / t for t in tri_secs]} rays/s on "
          f"{card}; K2 launches {k2t_launches}; png {png_bytes} B",
          flush=True)
    phase("tri_main_path", t0)

    # 18. K2's triangle modes at the triangle path's own state (launches
    # not counted). The listed mode: the whole launch, timed, must give the
    # path's image; every 32nd 256-lane block (whole blocks, so that each
    # lists as in the whole launch) is held bit for bit against the listed
    # plain version over all its steps; a launch with the counters on
    # gives the list pass rate (listed tiles over live block-steps x T)
    # and the pairs tested. The sweep (regen_steps(tri=) without boxes,
    # the mode a caller names): its whole launch, timed, with its own
    # launch count; its image within 20 pixels of the listed one's (a
    # list may skip a grazing hit), and 1 lane in 32 bit for bit against
    # the sweep's plain version. The bounds count the search alone: every
    # sphere of nonzero size, and the triangles of nonzero size (all of
    # them for the sweep, the block's listed tiles' for the listed mode)
    # charged by where each pair leaves the test, each cast ray; the pairs
    # are counted on the block slice's own rays, stepped through the
    # listed plain version one step at a time (which must end where its
    # one call of all steps did), and scaled from the slice's rays to the
    # path's
    t0 = time.perf_counter()
    ttable, ttri, tn_tri = regen_tables(tscene)
    tboxes = tab_tile_boxes(ttri)
    n_tiles_r = tboxes.shape[0]
    n_sph = ttable.shape[0] - tn_tri
    tsteps = TRI_SPP * MAX_BOUNCES
    kwt = dict(use_sky=tscene.use_sky, max_bounces=MAX_BOUNCES, width=MAIN_W,
               height=MAIN_H)
    tst0, tc13, tr2 = wave_init(tracer_t.camera, torch.as_tensor(
        perm, device=dev), TRI_SPP, SEED, 0, MAIN_W, MAIN_H)
    tst_k = tst0.clone()
    _, k2t_ms = timed(torch, lambda: regen_steps(
        tst_k, tc13, ttable, tsteps, tri=ttri, boxes=tboxes, **kwt))
    require(int(tst_k[22].to(torch.int64).sum()) == rays_t,
            "K2 listed launch rays differ from the path's")
    again = accumulate(tracer_t.init_state(), untile_image(
        tst_k[16:19].T, MAIN_W, MAIN_H, inv), TRI_SPP)
    require(torch.equal(again.mean, mean_t),
            "K2 listed launch image differs from the path's")
    k2t_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    tst_c = tst0.clone()
    regen_steps(tst_c, tc13, ttable, tsteps, tri=ttri, boxes=tboxes,
                stats=k2t_stats, **kwt)
    require(bits_equal(torch, tst_c, tst_k),
            "K2 listed launch with counters differs")
    del tst_c
    t_listed, t_live, t_tested = k2t_stats.tolist()
    k2t_pass = t_listed / max(t_live * n_tiles_r, 1)
    bcols = torch.arange(tr2, device=dev).view(-1, BLOCK_R)[
        ::SLICE_STRIDE].reshape(-1)
    tsl_k, tsl_p = tst0[:, bcols].contiguous(), tst0[:, bcols].contiguous()
    _, k2t_ms_slice = timed(torch, lambda: regen_steps(
        tsl_k, tc13, ttable, tsteps, tri=ttri, boxes=tboxes, **kwt))
    _, k2t_plain = timed(torch, lambda: regen_steps_plain(
        tsl_p, tc13, ttable, tsteps, tri=ttri, boxes=tboxes, **kwt))
    require(bits_equal(torch, tsl_k, tst_k[:, bcols]),
            "K2 listed mode on the block slice differs from the launch")
    k2t_err = (tsl_p[16:19] - tsl_k[16:19]).abs().max().item()
    require(bits_equal(torch, tsl_p, tsl_k),
            f"K2 listed mode: block slice not bit-equal to plain (image max "
            f"|d| {k2t_err})")
    # the sweep, on its own path: a caller naming it
    tst_s = tst0.clone()
    torch.cuda.synchronize()
    reset_counts()
    _, k2s_ms = timed(torch, lambda: regen_steps(tst_s, tc13, ttable, tsteps,
                                                 tri=ttri, **kwt))
    k2s_launches = regen_steps.launches
    require(k2s_launches == 1 and regen_steps.listed_launches == 0
            and sum(counts().values()) == 1,
            f"the sweep's call launched {counts()}")
    sweep_img = accumulate(tracer_t.init_state(), untile_image(
        tst_s[16:19].T, MAIN_W, MAIN_H, inv), TRI_SPP).mean
    n_px_sweep = int((sweep_img != mean_t).any(-1).sum())
    require(n_px_sweep <= 20, f"the listed route's trimesh image differs "
            f"from the sweep's on {n_px_sweep} pixels")
    ssl_k, ssl_p = tst0[:, cols].contiguous(), tst0[:, cols].contiguous()
    _, k2s_ms_slice = timed(torch, lambda: regen_steps(
        ssl_k, tc13, ttable, tsteps, tri=ttri, **kwt))
    _, k2s_plain = timed(torch, lambda: regen_steps_plain(
        ssl_p, tc13, ttable, tsteps, tri=ttri, **kwt))
    require(bits_equal(torch, ssl_k, tst_s[:, cols]),
            "K2 sweep on the lane slice differs from the launch")
    k2s_err = (ssl_p[16:19] - ssl_k[16:19]).abs().max().item()
    require(bits_equal(torch, ssl_p, ssl_k),
            f"K2 sweep: slice not bit-equal to plain (image max |d| "
            f"{k2s_err})")
    del ssl_k, ssl_p
    cnt_st = tst0[:, bcols].contiguous()
    blk_sl = torch.arange(cnt_st.shape[1], device=dev) // BLOCK_R
    slice_all_flops = slice_list_flops = 0
    slice_rays = slice_pairs = 0
    exits_all, exits_list = [], []
    for _ in range(tsteps):
        alive = cnt_st[12] > 0.5
        if bool(alive.any()):
            reach = _block_reach(tboxes, cnt_st)[blk_sl[alive]]
            o_a, d_a = cnt_st[0:3, alive].T, cnt_st[3:6, alive].T
            f, sh = mt_work(torch, ttri, o_a, d_a)
            slice_all_flops += f
            exits_all.append((int(alive.sum()), sh))
            f, sh = mt_work(torch, ttri, o_a, d_a, reach)
            slice_list_flops += f
            exits_list.append((int(alive.sum()), sh))
            slice_pairs += int(reach.sum()) * TRI_BLOCK_M
            slice_rays += int(alive.sum())
        regen_steps_plain(cnt_st, tc13, ttable, 1, tri=ttri, boxes=tboxes,
                          **kwt)
    require(bits_equal(torch, cnt_st, tsl_p)
            and slice_rays == int(tsl_p[22].to(torch.int64).sum()),
            "the listed plain version stepped one step at a time differs")
    del cnt_st

    def mean_exits(exits):
        return {k: sum(n * sh.get(k, 0.0) for n, sh in exits) / slice_rays
                for k in ("det", "u", "whole")}

    k2t_exits, k2s_exits = mean_exits(exits_list), mean_exits(exits_all)
    sph_flops = rays_t * n_sph_real * FLOPS_PER_PAIR
    tri_flops_all = sph_flops + rays_t * slice_all_flops / slice_rays
    tri_flops = sph_flops + rays_t * slice_list_flops / slice_rays
    t_pairs_listed = slice_pairs * rays_t / slice_rays
    tri_bytes = (2 * STATE_BYTES * tr2 + n_sph_real * SPHERE_BYTES
                 + n_tri_real * (TRI_BYTES + SPHERE_BYTES) + 52)
    k2t_bound, k2t_by = bound(tri_flops, tri_bytes)
    k2s_bound, k2s_by = bound(tri_flops_all, tri_bytes)
    # the listed mode's own work: the pairs its front-to-back fold tested
    # (its counters), each priced by the exit mix of the listed pairs
    tested_flops = sph_flops + t_tested * pair_flops(k2t_exits)
    k2t_tbound, k2t_tby = bound(tested_flops, tri_bytes)
    path_t = (f"triangle main: render --scene trimesh fused+regen "
              f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    kernels["regen_steps_tri"] = dict(
        name="regen_steps_tri", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:812",
        launches=k2t_launches, max_abs_err=k2t_err, ms=k2t_ms,
        plain_ms=k2t_plain, bound_ms=k2t_tbound, bound_by=k2t_tby,
        library_ms=None, path=path_t,
        shape=f"{tr2} lanes x {tsteps} steps, {rays_t} rays, "
              f"{ttable.shape[0]} primitives ({n_sph_real} spheres and "
              f"{n_tri_real} triangles real) in {n_tiles_r} tiles; bound "
              f"over the pairs tested",
        bound_listed_pairs_ms=k2t_bound, bound_all_triangles_ms=k2s_bound,
        list_pass_rate=k2t_pass,
        pairs_listed=t_pairs_listed, pairs_tested=t_tested,
        plain_lanes=tsl_p.shape[1], same_lanes="every 32nd 256-lane block",
        ms_same_lanes=k2t_ms_slice, pairs_leaving_at=k2t_exits)
    kernels["regen_steps_tri_sweep"] = dict(
        name="regen_steps_tri_sweep", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:868",
        launches=k2s_launches, max_abs_err=k2s_err, ms=k2s_ms,
        plain_ms=k2s_plain, bound_ms=k2s_bound, bound_by=k2s_by,
        library_ms=None,
        path=f"regen_steps(tri=) without tile boxes (the sweep a caller "
             f"names), at the triangle path's state: trimesh "
             f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp",
        shape=f"{tr2} lanes x {tsteps} steps, {rays_t} rays, every "
              f"triangle", pixels_differing_from_listed=n_px_sweep,
        plain_lanes=tsl_p.shape[1], ms_same_lanes=k2s_ms_slice,
        pairs_leaving_at=k2s_exits)
    print(f"K2 listed mode at the triangle path: {k2t_ms:.3f} ms (bound "
          f"{k2t_tbound:.3f} ms by {k2t_tby} over the {t_tested} pairs "
          f"tested, {k2t_bound:.3f} ms over the {t_pairs_listed:.6e} listed "
          f"pairs, {k2s_bound:.3f} ms over every triangle; regen list pass "
          f"rate {k2t_pass:.4f} ({t_listed} "
          f"listed tiles over {t_live} live block-steps x {n_tiles_r} "
          f"tiles); listed pairs leaving the test at {k2t_exits}); every "
          f"32nd block ({tsl_p.shape[1]} lanes) bit-equal to plain, "
          f"{k2t_ms_slice:.3f} ms kernel / {k2t_plain:.3f} ms plain on "
          f"them. Sweep (1 launch on its own call): {k2s_ms:.3f} ms (bound "
          f"{k2s_bound:.3f} ms by {k2s_by}), {n_px_sweep} pixels differ "
          f"from the listed route's image; 1 lane in {SLICE_STRIDE} "
          f"bit-equal to plain, {k2s_ms_slice:.3f} ms kernel / "
          f"{k2s_plain:.3f} ms plain", flush=True)
    phase("k2_tri_check", t0)

    # 19. the triangle path's forward+backward, as a user differentiates
    # it: image_mse(render_mean(trainable trimesh, ...), 0).backward()
    # w.r.t. every sphere leaf, every triangle leaf and the camera, three
    # calls (BASELINE.md config 4's gradient row)
    t0 = time.perf_counter()
    tsc = trainable_scene(tscene)
    tcm = trainable_camera(tracer_t.camera)
    tleaves = [tsc.leaf(k) for k in tsc.leaves] + [tcm.position,
                                                   tcm.look_at]

    def tri_fwd_bwd():
        for leaf in tleaves:
            leaf.grad = None
        img_g, rays_g = render_mean(tsc, tcm, width=MAIN_W, height=MAIN_H,
                                    spp=TRI_SPP, seed=SEED,
                                    max_bounces=MAX_BOUNCES, backend="fused",
                                    regen=True, return_rays=True)
        image_mse(img_g, target).backward()
        return img_g.detach(), rays_g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0_t = torch.cuda.memory_allocated()
    reset_counts()
    tri_step_secs = []
    t_step = time.perf_counter()
    img_tg, rays_tg = tri_fwd_bwd()
    torch.cuda.synchronize()
    tri_step_secs.append(time.perf_counter() - t_step)
    launches_t = counts()
    peak_t = torch.cuda.max_memory_allocated() - mem0_t
    require(launches_t["regen_record"] > 0 and launches_t["regen_bwd"] > 0,
            f"triangle fwd+bwd did not launch K2-record and K3: {launches_t}")
    require(regen_record.listed_launches == launches_t["regen_record"],
            "triangle fwd+bwd did not take K2-record's listed mode")
    require(sum(launches_t.values()) == launches_t["regen_record"]
            + launches_t["regen_bwd"],
            f"triangle fwd+bwd launched other kernels: {launches_t}")
    require(rays_tg == rays_t, f"triangle fwd+bwd rays {rays_tg} != {rays_t}")
    require(torch.equal(img_tg, mean_t),
            "triangle recording forward's image differs from the forward's")
    tgrads = {k: tsc.leaf(k).grad for k in tsc.leaves}
    tgrads.update(position=tcm.position.grad, look_at=tcm.look_at.grad)
    for k, g_ in tgrads.items():
        require(g_ is not None and bool(torch.isfinite(g_).all()),
                f"trimesh gradient of {k} missing or not finite")
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo", "position"):
        require(tgrads[k].abs().max().item() > 0,
                f"trimesh gradient of {k} is zero")
    tri_grads = {k: g_.clone() for k, g_ in tgrads.items()}
    for _ in range(2):
        t_step = time.perf_counter()
        tri_fwd_bwd()
        torch.cuda.synchronize()
        tri_step_secs.append(time.perf_counter() - t_step)
    print(f"triangle fwd+bwd: trimesh {MAIN_W}x{MAIN_H} {TRI_SPP} spp "
          f"fused+regen: {rays_tg} rays; step {tri_step_secs} s = "
          f"{[rays_tg / t for t in tri_step_secs]} rays/s on {card}; "
          f"launches {launches_t}; peak memory {peak_t} B above the "
          f"{mem0_t} B held before", flush=True)
    phase("tri_fwd_bwd", t0)

    # 20. K2-record and K3's triangle branch at the triangle path's own
    # state and records (launches not counted): K2-record's listed mode
    # leaves the forward-only listed K2's state and, on every 32nd 256-lane
    # block, the listed plain version's state and records; its sweep
    # leaves the forward-only sweep's state; K3 (two launches, bit-equal)
    # at the main loss's cotangent: its d_table against the path's
    # gradients, and on 1 lane in 32 d_state equal to plain, d_table and
    # d_cam within 1e-4 of each group's max of the plain f64 sum (sphere
    # and triangle rows apart); one more launch counts its merges (one a
    # step of each lane tile, rows touched, partial bytes)
    t0 = time.perf_counter()
    seg_t = min(SEG_MAX, tsteps)
    tst_r = tst0.clone()
    trecs, k2tr_ms = timed(torch, lambda: regen_record(
        tst_r, tc13, ttable, tsteps, seg_t, tri=ttri, boxes=tboxes, **kwt))
    require(bits_equal(torch, tst_r, tst_k),
            "K2-record listed state differs from the forward-only K2's")
    tsl_r, tsl_pr = tst0[:, bcols].contiguous(), tst0[:, bcols].contiguous()
    trecs_s, k2tr_ms_slice = timed(torch, lambda: regen_record(
        tsl_r, tc13, ttable, tsteps, seg_t, tri=ttri, boxes=tboxes, **kwt))
    (_, trecs_p), k2tr_plain = timed(torch, lambda: regen_steps_plain(
        tsl_pr, tc13, ttable, tsteps, seg=seg_t, tri=ttri, boxes=tboxes,
        **kwt))
    require(bits_equal(torch, tsl_r, tsl_pr),
            "K2-record listed block slice state not bit-equal to plain")
    t_end_p = trecs_p.t_end.long()
    valid = torch.arange(tsteps, device=dev)[:, None] < t_end_p[None, :]
    require(torch.equal(trecs_s.t_end, trecs_p.t_end)
            and torch.equal(trecs_s.rec[valid], trecs_p.rec[valid]),
            "K2-record listed records differ from plain")
    require(torch.equal(trecs_s.rec[valid], trecs.rec[:, bcols][valid])
            and torch.equal(trecs_s.t_end, trecs.t_end[bcols]),
            "K2-record listed records on the block slice differ from the "
            "launch's")
    for q in range(trecs_p.chk.shape[0]):
        on = t_end_p > q * seg_t
        require(bits_equal(torch, trecs_s.chk[q][:, on],
                           trecs_p.chk[q][:, on]),
                f"K2-record listed checkpoint {q} differs from plain")
    require(bool((trecs_p.rec[valid] >= n_sph).any()),
            "the triangle path recorded no triangle winner")
    del trecs_s, tsl_r
    tst_rs = tst0.clone()
    regen_record(tst_rs, tc13, ttable, tsteps, seg_t, tri=ttri, **kwt)
    require(bits_equal(torch, tst_rs, tst_s),
            "K2-record sweep state differs from the forward-only sweep's")
    del tst_rs
    n_chk_t = int(((trecs.t_end.long() + seg_t - 1) // seg_t).sum())
    rec_bytes = 2 * rays_t + STATE_BYTES * n_chk_t + 4 * tr2
    k2tr_bound, k2tr_by = bound(tested_flops, tri_bytes + rec_bytes)
    path_tg = (f"triangle main fwd+bwd: render_mean trimesh fused+regen "
               f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    kernels["regen_record_tri"] = dict(
        name="regen_record_tri", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:812",
        launches=launches_t["regen_record"], max_abs_err=0.0, ms=k2tr_ms,
        plain_ms=k2tr_plain, bound_ms=k2tr_bound, bound_by=k2tr_by,
        library_ms=None, path=path_tg,
        shape=f"{tr2} lanes x {tsteps} steps, seg {seg_t}, {rays_t} rays; "
              f"bound over the pairs tested",
        bound_listed_pairs_ms=bound(tri_flops, tri_bytes + rec_bytes)[0],
        forward_only_ms=k2t_ms, plain_lanes=tsl_pr.shape[1],
        same_lanes="every 32nd 256-lane block",
        ms_same_lanes=k2tr_ms_slice)

    tcol = tst_k[16:19].T.contiguous().requires_grad_()
    image_mse(untile_image(tcol, MAIN_W, MAIN_H, inv)
              / torch.tensor(float(TRI_SPP), device=dev), target).backward()
    td_out = torch.zeros_like(tst0)
    td_out[16:19] = tcol.grad.T
    (td_st, td_tab, td_cam), k3t_ms = timed(torch, lambda: regen_bwd(
        trecs, td_out, tc13, ttable, n_tri=tn_tri, **kwt))
    again = regen_bwd(trecs, td_out, tc13, ttable, n_tri=tn_tri, **kwt)
    require(all(bits_equal(torch, a, b) for a, b in zip(
        (td_st, td_tab, td_cam), again)),
        "K3: two launches on the triangle path's records differ")
    del again
    tperm = tri_morton_perm(tscene.tris)
    sperm_t = morton_perm(tscene)
    for name, got, want in (
            ("sphere albedo", td_tab[:n_sph, 4:7],
             tri_grads["albedo"][sperm_t]),
            ("triangle albedo", td_tab[n_sph:, 4:7],
             tri_grads["tris.albedo"][tperm]),
            ("triangle emissive", td_tab[n_sph:, 7:10],
             tri_grads["tris.emissive"][tperm])):
        err = (got - want).abs().max().item()
        require(err <= 1e-4 * want.abs().max().item(),
                f"K3 d_table ({name}) differs from the path's by {err}")
    trecs_sl = type(trecs)(trecs.rec[:, cols].contiguous(),
                           trecs.chk[:, :, cols].contiguous(),
                           trecs.t_end[cols].contiguous(), seg_t)
    td_out_s = td_out[:, cols].contiguous()
    (k_st, k_tab, k_cam), k3t_ms_slice = timed(torch, lambda: regen_bwd(
        trecs_sl, td_out_s, tc13, ttable, n_tri=tn_tri, **kwt))
    (p_st, p_tab, p_cam), k3t_plain = timed(torch, lambda: regen_bwd_plain(
        trecs_sl, td_out_s, tc13, ttable, n_tri=tn_tri, **kwt))
    require(torch.equal(k_st, td_st[:, cols]),
            "K3 triangle slice differs from the whole launch")
    require(torch.equal(k_st[rows], p_st[rows]),
            f"K3 triangle d_state differs from plain by "
            f"{(k_st[rows] - p_st[rows]).abs().max().item()}")
    k3t_err = 0.0
    groups = []
    for part, sl in (("sphere", slice(0, n_sph)), ("triangle",
                                                   slice(n_sph, None))):
        for c in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                  slice(10, 11), slice(11, 12)):
            groups.append((f"{part} rows, cols {c.start}-{c.stop - 1}",
                           k_tab[sl, c], p_tab[sl, c]))
    groups += [(f"cam[{a}:{a + 3}]", k_cam[a:a + 3], p_cam[a:a + 3])
               for a in (0, 3, 6, 9)]
    for name, a, b in groups:
        err = (a - b).abs().max().item()
        k3t_err = max(k3t_err, err)
        require(err <= 1e-4 * b.abs().max().item(),
                f"K3 triangle {name} differs from plain by {err}")
    t_end_t = trecs.t_end.long()
    k3t_info = regen_bwd_info(ttable.shape[0], dev)
    print(f"K3 triangle branch launch 1: {k3t_info}", flush=True)
    # the global-row merge's counts on one more launch: one merge a step
    # of each lane tile up to its last alive lane
    k3t_stats = torch.zeros(MERGE_STATS, dtype=torch.int64, device=dev)
    k3t_again = regen_bwd(trecs, td_out, tc13, ttable, n_tri=tn_tri,
                          stats=k3t_stats, **kwt)
    require(bits_equal(torch, k3t_again[1], td_tab),
            "K3: the launch with counts differs from the launch without")
    del k3t_again
    k3t_parts = build.load().trt_regen_bwd_parts(tr2, ttable.shape[0])
    k3t_th = k3t_info["threads"]
    k3t_steps = int(torch.nn.functional.pad(
        t_end_t.clamp(max=tsteps), (0, -tr2 % k3t_th)).view(
            -1, k3t_th).amax(dim=1).sum())
    require(int(k3t_stats[0]) == k3t_steps,
            f"K3 merged {int(k3t_stats[0])} steps, its tiles have "
            f"{k3t_steps}")
    k3t_merge = merge_record(k3t_stats, k3t_parts, ttable.shape[0], 1)
    k3t_merge["merge_rounds_per_step"] = int(k3t_stats[0]) / k3t_steps
    print(f"K3 triangle branch merge: {k3t_parts} blocks, {k3t_merge}",
          flush=True)
    k3t_bound, k3t_by = bound(
        rays_t * K3_FLOPS_PER_STEP,
        2 * rays_t + STATE_BYTES * n_chk_t + 4 * tr2 + 15 * 4 * tr2
        + STATE_BYTES * tr2 + 2 * 48 * (n_sph_real + n_tri_real) + 52)
    kernels["regen_bwd_tri"] = dict(
        name="regen_bwd_tri", route="cuda",
        source="tpu_ray_torch/csrc/regen_bwd.cu",
        replaces="tpu_ray/kernels/regen.py:967",
        launches=launches_t["regen_bwd"], max_abs_err=k3t_err, ms=k3t_ms,
        plain_ms=k3t_plain, bound_ms=k3t_bound, bound_by=k3t_by,
        library_ms=None, path=path_tg,
        shape=f"{tr2} lanes, {int(t_end_t.sum())} alive lane-steps, seg "
              f"{seg_t}, {ttable.shape[0]} table rows",
        plain_lanes=trecs_sl.t_end.shape[0], ms_same_lanes=k3t_ms_slice,
        partial_bytes=k3t_parts * ttable.numel() * 4, parts=k3t_parts,
        fwd_bwd_peak_bytes=peak_t, **k3t_merge, **k3t_info)
    print(f"K2-record listed mode: {k2tr_ms:.3f} ms (forward-only "
          f"{k2t_ms:.3f} ms), state bit-equal to forward-only, every 32nd "
          f"block: state, records and checkpoints equal to plain, "
          f"{k2tr_ms_slice:.3f} ms kernel / {k2tr_plain:.3f} ms plain; "
          f"K2-record sweep state bit-equal to the sweep's; K3 triangle "
          f"branch at "
          f"the triangle path: {k3t_ms:.3f} ms (bound {k3t_bound:.3f} ms by "
          f"{k3t_by}), two launches bit-equal, d_table equal to the path's "
          f"within 1e-4; 1 lane in {SLICE_STRIDE}: d_state equal to plain, "
          f"d_table and d_cam within 1e-4 of each group's max (max |d| "
          f"{k3t_err}), {k3t_ms_slice:.3f} ms kernel / {k3t_plain:.3f} ms "
          f"plain", flush=True)
    phase("k3_tri_check", t0)
    del trecs, trecs_p, trecs_sl, tst_r

    # 21. the triangle routes' gradients, fused+regen's and the
    # per-sample route's (K8, K5, K6), against backend cuda autograd (the
    # eager route: Möller-Trumbore payload, K1 and K7 searches) on trimesh
    # at 320x180, 4 spp: each group within 3e-3 of its max
    t0 = time.perf_counter()
    tsmall, k11_tsmall = {}, {}
    for route, backend, regen in (("fused", "fused", True),
                                  ("sample", "fused", False),
                                  ("cuda", "cuda", False)):
        k11_before = gather_rows_bwd.launches
        s2 = trainable_scene(tscene)
        c2 = trainable_camera(tcam)
        img2 = render_mean(s2, c2, width=CHECK_W, height=CHECK_H,
                           spp=CHECK_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                           backend=backend, regen=regen)
        image_mse(img2, torch.zeros_like(img2)).backward()
        k11_tsmall[route] = gather_rows_bwd.launches - k11_before
        tsmall[route] = {k: s2.leaf(k).grad for k in s2.leaves}
        tsmall[route].update(position=c2.position.grad,
                             look_at=c2.look_at.grad)
    tri_rel = {"fused": {}, "sample": {}}
    for route, rel in tri_rel.items():
        for k, b in tsmall["cuda"].items():
            a = tsmall[route][k]
            rel[k] = ((a - b).abs().max()
                      / b.abs().max().clamp_min(1e-12)).item()
            require(rel[k] < 3e-3 or b.abs().max().item() == 0.0
                    and a.abs().max().item() == 0.0,
                    f"trimesh {route} grad {k} differs from cuda by "
                    f"{rel[k]}")
    print(f"trimesh fused+regen and per-sample vs backend cuda autograd "
          f"gradients, {CHECK_W}x{CHECK_H} {CHECK_SPP} spp: max relative "
          f"per group {tri_rel}", flush=True)
    phase("tri_grad_check", t0)

    # 22. K8 and the triangle modes of K5 and K6 at the triangle
    # per-sample route's own inputs: trimesh's main camera, sample 0 at
    # full width, bounce after bounce (launches not counted). On every
    # 32nd 256-lane block of each bounce's input state (whole blocks, so
    # each lists as in the whole launch) K8 is bit-equal to its plain
    # version (whose lists come from the plain tri_block_lists at 256-lane
    # blocks) and to the whole launch, K5 to K8 and to its plain version;
    # at full width K5 replays K8, and K8's counters (listed tiles, live
    # blocks, pairs tested) are read. K6 at the route's own records, the cotangent of
    # sum(color^2) / 2: at full width two launches bit-equal (P = 10,496:
    # the accumulator rows in global memory; the second launch counts its
    # merges), and on all lanes and on the slice d_state equal to plain,
    # d_table within 1e-4 of each group's max (sphere rows and triangle
    # rows apart) of the plain f64 sum; on the slice d_table bit for bit
    # the fixed order (table_sum_fixed_order) over the plain version's
    # lane terms, with the same counts
    t0 = time.perf_counter()
    ttb = fused_tables(tscene,
                       origin_bound(default_camera(tscene).position[None]))
    tkw = dict(n_sph=ttb.n_sph, use_sky=tscene.use_sky)
    t_groups = [(f"{part} rows, cols {c.start}-{c.stop - 1}", sl_, c)
                for part, sl_ in (("sphere", slice(0, ttb.n_sph)),
                                  ("triangle", slice(ttb.n_sph, None)))
                for c in (slice(0, 3), slice(3, 4), slice(4, 7),
                          slice(7, 10), slice(10, 11), slice(11, 12))]

    def k6_tri_close(got, want, what):
        worst = 0.0
        for name, rows_, c in t_groups:
            err = (got[rows_, c] - want[rows_, c]).abs().max().item()
            worst = max(worst, err)
            require(err <= 1e-4 * want[rows_, c].abs().max().item(),
                    f"{what}: d_table {name} differs from plain by {err}")
        return worst

    tslice_ms = {"bounce_fwd_list": [0.0, 0.0], "bounce_replay": [0.0, 0.0],
                 "bounce_bwd": [0.0, 0.0]}     # kernel, plain
    k8s_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    st = init_state(*camera_rays(tracer_t.camera, MAIN_W, MAIN_H, px_all, 0,
                                 SEED))
    states, idxs = [], []
    for b in range(MAX_BOUNCES):
        out_k, idx_k = bounce_fwd_list(st, ttb.table, ttb.tri, ttb.boxes, b,
                                       stats=k8s_stats, **tkw)
        rep = bounce_replay(st, ttb.table, idx_k, b, **tkw)
        require(bits_equal(torch, rep, out_k),
                f"K5 triangle mode, bounce {b}: not K8's state bit for bit")
        sl = st[:, bcols].contiguous()
        (out_s, idx_s), ms_k = timed(torch, lambda: bounce_fwd_list(
            sl, ttb.table, ttb.tri, ttb.boxes, b, **tkw))
        (out_p, idx_p), ms_p = timed(torch, lambda: bounce_fwd_list_plain(
            sl, ttb.table, ttb.tri, ttb.boxes, b, **tkw))
        require(torch.equal(idx_s, idx_p) and bits_equal(torch, out_s, out_p),
                f"K8 bounce {b}: the block slice differs from plain on "
                f"{int((idx_s != idx_p).sum())} winners")
        require(torch.equal(idx_s, idx_k[bcols])
                and bits_equal(torch, out_s, out_k[:, bcols].contiguous()),
                f"K8 bounce {b}: the block slice differs from the launch")
        rep_s, ms_rk = timed(torch, lambda: bounce_replay(
            sl, ttb.table, idx_s, b, **tkw))
        rep_p, ms_rp = timed(torch, lambda: bounce_replay_plain(
            sl, ttb.table, idx_s, b, **tkw))
        require(bits_equal(torch, rep_s, out_s)
                and bits_equal(torch, rep_p, out_s),
                f"K5 triangle mode, bounce {b}: the slice is not K8's state")
        tslice_ms["bounce_fwd_list"][0] += ms_k
        tslice_ms["bounce_fwd_list"][1] += ms_p
        if b < MAX_BOUNCES - 1:       # the backward replays B-1 bounces
            tslice_ms["bounce_replay"][0] += ms_rk
            tslice_ms["bounce_replay"][1] += ms_rp
        states.append(st)
        idxs.append(idx_k)
        st = out_k
    require(bool((torch.stack(idxs) >= ttb.n_sph).any()),
            "the per-sample trimesh route found no triangle winner")
    del out_k, out_s, out_p, rep, rep_s, rep_p
    d = torch.zeros_like(st)
    d[9:12] = st[9:12]                # the cotangent of sum(color^2) / 2
    k6t_err = 0.0
    k6t_n = ttb.table.shape[0]
    k6t_parts = build.load().trt_bounce_bwd_parts(px_all.shape[0], k6t_n)
    k6t_parts_s = build.load().trt_bounce_bwd_parts(px_all[cols].shape[0],
                                                    k6t_n)
    k6t_threads = build.load().trt_bounce_bwd_threads(k6t_n)
    k6t_stats = torch.zeros(MERGE_STATS, dtype=torch.int64, device=dev)
    for b in reversed(range(MAX_BOUNCES)):
        d_k, tab_k = bounce_bwd(states[b], ttb.table, idxs[b], b, d.clone(),
                                **tkw)
        d_k2, tab_k2 = bounce_bwd(states[b], ttb.table, idxs[b], b,
                                  d.clone(), stats=k6t_stats, **tkw)
        require(bits_equal(torch, d_k, d_k2) and bits_equal(torch, tab_k,
                                                            tab_k2),
                f"K6 triangle mode, bounce {b}: two launches differ (the "
                f"second with counts)")
        d_p, tab_p = bounce_bwd_plain(states[b], ttb.table, idxs[b], b,
                                      d.clone(), **tkw)
        require(torch.equal(d_k, d_p), f"K6 triangle mode full width, "
                f"bounce {b}: d_state differs from plain by "
                f"{(d_k - d_p).abs().max().item()}")
        k6t_err = max(k6t_err, k6_tri_close(
            tab_k, tab_p, f"K6 triangle mode full width, bounce {b}"))
        del d_k2, tab_k2, d_p, tab_p
        st_s = states[b][:, cols].contiguous()
        i_s = idxs[b][cols].contiguous()
        d_s = d[:, cols].contiguous()
        (dk_s, tk_s), ms_k = timed(torch, lambda: bounce_bwd(
            st_s, ttb.table, i_s, b, d_s.clone(), **tkw))
        (dp_s, tp_s), ms_p = timed(torch, lambda: bounce_bwd_plain(
            st_s, ttb.table, i_s, b, d_s.clone(), **tkw))
        require(torch.equal(dk_s, dp_s) and torch.equal(dk_s, d_k[:, cols]),
                f"K6 triangle mode, bounce {b}: slice d_state differs")
        k6t_err = max(k6t_err, k6_tri_close(
            tk_s, tp_s, f"K6 triangle mode slice, bounce {b}"))
        # the slice's d_table bit for bit in the fixed order over the plain
        # version's lane terms, and its counts the plain order's
        _, dwn_s = bounce_bwd_lanes_plain(st_s, ttb.table, i_s, b, d_s,
                                          **tkw)
        fx_s, fx_counts = table_sum_fixed_order(
            i_s, dwn_s, k6t_n, threads=k6t_threads,
            parts=k6t_parts_s, counts=True)
        require(bits_equal(torch, tk_s, fx_s),
                f"K6 triangle mode slice, bounce {b}: d_table differs from "
                f"table_sum_fixed_order on {int((tk_s != fx_s).sum())} "
                f"entries")
        sl_stats = torch.zeros(MERGE_STATS, dtype=torch.int64, device=dev)
        bounce_bwd(st_s, ttb.table, i_s, b, d_s.clone(), stats=sl_stats,
                   **tkw)
        require(torch.equal(sl_stats, fx_counts),
                f"K6 triangle mode slice, bounce {b}: counts "
                f"{sl_stats.tolist()}, the plain order's "
                f"{fx_counts.tolist()}")
        tslice_ms["bounce_bwd"][0] += ms_k
        tslice_ms["bounce_bwd"][1] += ms_p
        d = d_k
    k6t_steps = MAX_BOUNCES * -(-px_all.shape[0] // k6t_threads)
    require(int(k6t_stats[0]) == k6t_steps,
            f"K6 merged {int(k6t_stats[0])} lane tiles over "
            f"{MAX_BOUNCES} launches of {k6t_steps // MAX_BOUNCES}")
    k6t_merge = merge_record(k6t_stats, k6t_parts, ttb.table.shape[0],
                             MAX_BOUNCES)
    # a step of K6 is a lane tile
    k6t_merge["merge_rounds_per_step"] = int(k6t_stats[0]) / k6t_steps
    print(f"K6 triangle mode merge, sample 0's {MAX_BOUNCES} launches of "
          f"{k6t_parts} blocks: {k6t_merge}; the slice's d_table bit-equal "
          f"to table_sum_fixed_order over bounce_bwd_lanes_plain's terms "
          f"and its counts equal", flush=True)
    k8s_listed, k8s_live, k8s_pairs = k8s_stats.tolist()
    tsl_lanes = sl.shape[1]
    print(f"K8/K5/K6 triangle modes at the per-sample trimesh route's "
          f"inputs, sample 0: 1 256-lane block in {SLICE_STRIDE} "
          f"({sl.shape[1]} lanes) K8 bit-equal to plain and to the launch, "
          f"K8's counters over the 5 launches: {k8s_listed} listed tiles "
          f"over {k8s_live} live blocks x {ttb.boxes.shape[0]} tiles, "
          f"{k8s_pairs} pairs tested; K5 bit-equal to K8 (and at full "
          f"width); K6 ({k6t_parts} blocks, {ttb.table.shape[0]} table "
          f"rows) two launches bit-equal, d_state equal to plain on all "
          f"lanes and the slice, d_table within 1e-4 (max |d| {k6t_err}); "
          f"kernel / plain ms on the slice {tslice_ms}", flush=True)
    phase("k8_tri_check", t0)
    del states, idxs, st, d, d_k, tab_k, dk_s, dp_s

    # 23. the per-sample route on trimesh as the CLI drives it (render
    # --scene trimesh --backend fused --no-regen), two calls, against the
    # regen route's image of phase 17: the lists may skip a grazing hit
    # that the regen route's full sweep folds (Möller-Trumbore acceptance
    # fuzz), so the differing pixels are counted, at most 20. Then the
    # pass's own states again, bounce by bounce (launches not counted):
    # the list pass rate (listed tile folds over live block-steps x T),
    # K8's device time by CUDA events and its bound (real sphere pairs x
    # 20 flops, plus the listed triangle pairs charged by where they leave
    # the test, counted on 1 lane in 32 of each state with its full-width
    # block's list and scaled by the alive lanes); then one pass under
    # torch.profiler
    t0 = time.perf_counter()
    cfg_ts = RenderConfig(scene="trimesh", width=MAIN_W, height=MAIN_H,
                          spp=TRI_SPP, max_bounces=MAX_BOUNCES,
                          backend="fused", seed=SEED, regen=False)
    tracer_ts = PathTracer(cfg_ts, scene=tscene, device=dev)
    tfwd_secs = []
    for _ in range(2):
        state0 = tracer_ts.init_state()
        torch.cuda.synchronize()
        reset_counts()
        t_main = time.perf_counter()
        state_ts, rays_ts = tracer_ts.step(state0)
        torch.cuda.synchronize()
        tfwd_secs.append(time.perf_counter() - t_main)
        k8_launches = bounce_fwd_list.launches
        require(k8_launches == TRI_SPP * MAX_BOUNCES,
                f"per-sample trimesh forward launched K8 {k8_launches} "
                f"times")
        require(sum(counts().values()) == k8_launches,
                f"per-sample trimesh forward launched others: {counts()}")
    mean_ts = state_ts.mean
    require(bool(torch.isfinite(mean_ts).all()) and
            tuple(mean_ts.shape) == (MAIN_H, MAIN_W, 3), "trimesh per-sample")
    require(mean_ts.mean().item() > 0.01, "trimesh per-sample image black")
    tpx = (mean_ts != mean_t).any(-1)
    n_px = int(tpx.sum())
    max_px = (mean_ts - mean_t).abs().max().item()
    require(n_px <= 20, f"per-sample trimesh image differs from the regen "
            f"route's on {n_px} pixels (max {max_px}), rays {rays_ts} vs "
            f"{rays_t}")
    print(f"per-sample forward: trimesh {MAIN_W}x{MAIN_H} {TRI_SPP} spp "
          f"fused --no-regen: {rays_ts} rays in {tfwd_secs} s = "
          f"{[rays_ts / t for t in tfwd_secs]} rays/s on {card}; K8 launches "
          f"{k8_launches}; against fused+regen: rays differ by "
          f"{rays_ts - rays_t}, {n_px} of {MAIN_W * MAIN_H} pixels differ "
          f"(max |d| {max_px})", flush=True)

    n_tiles_t = ttb.boxes.shape[0]
    lanes_sl = torch.arange(0, px_all.shape[0], SLICE_STRIDE, device=dev)
    tab_bytes_t = ttb.table.numel() * 4
    folds = live_blocks = alive_all = alive_sl = 0
    tri_flops_sl, k8_ev_ms = 0, 0.0
    k8_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    k8_exits = []                    # (alive lanes of the slice, exit mix)
    twork = {n: [0.0, 0.0, 0] for n in ("bounce_fwd_list", "bounce_replay",
                                        "bounce_bwd")}  # flops, bytes, n
    with torch.no_grad():
        for k in range(TRI_SPP):
            st = init_state(*camera_rays(tracer_ts.camera, MAIN_W, MAIN_H,
                                         px_all, k, SEED))
            for b in range(MAX_BOUNCES):
                alive = st[12] > 0.5
                cnt, lst = tri_block_lists(ttb.boxes, st, BLOCK_R)
                reach = torch.zeros_like(lst, dtype=torch.bool)
                reach.scatter_(1, lst.long(), torch.arange(
                    n_tiles_t, device=dev)[None, :] < cnt)
                blk = torch.nn.functional.pad(
                    alive, (0, -alive.shape[0] % BLOCK_R)).view(
                        -1, BLOCK_R).any(dim=1)
                folds += int(cnt[blk].sum())
                live_blocks += int(blk.sum())
                a_sl = alive[lanes_sl]
                f, sh = mt_work(torch, ttb.tri, st[0:3, lanes_sl][:, a_sl].T,
                                st[3:6, lanes_sl][:, a_sl].T,
                                reach[lanes_sl[a_sl] // BLOCK_R])
                tri_flops_sl += f
                k8_exits.append((int(a_sl.sum()), sh))
                alive_sl += int(a_sl.sum())
                alive_all += int(alive.sum())
                bounce_fwd_list(st, ttb.table, ttb.tri, ttb.boxes, b,
                                stats=k8_stats, **tkw)
                (st, idx), ms = timed(torch, lambda: bounce_fwd_list(
                    st, ttb.table, ttb.tri, ttb.boxes, b, **tkw))
                k8_ev_ms += ms
                live = (idx >= 0).double().sum()
                todo = [("bounce_fwd_list", 0.0,
                         (2 * BOUNCE_STATE_BYTES + 4) * st.shape[1]
                         + tab_bytes_t + ttb.tri.numel() * 4
                         + ttb.boxes.numel() * 4),
                        ("bounce_bwd", live * K6_FLOPS_PER_LANE,
                         K6_LANE_BYTES * st.shape[1] + 2 * tab_bytes_t)]
                if b < MAX_BOUNCES - 1:
                    todo.append(("bounce_replay", live * K5_FLOPS_PER_LANE,
                                 (2 * BOUNCE_STATE_BYTES + 4) * st.shape[1]
                                 + tab_bytes_t))
                for n, f_, b_ in todo:
                    twork[n][0] = twork[n][0] + f_
                    twork[n][1] += b_
                    twork[n][2] += 1
    require(alive_all == rays_ts, f"the bounds' bounce loop cast {alive_all} "
            f"rays, the route {rays_ts}")
    del st, idx, cnt, lst, reach
    pass_rate = folds / max(live_blocks * n_tiles_t, 1)
    k8_listed, k8_live, k8_pairs = k8_stats.tolist()
    require((k8_listed, k8_live) == (folds, live_blocks),
            f"K8's counters list {k8_listed} tiles over {k8_live} live "
            f"blocks, the plain lists {folds} over {live_blocks}")
    # the bound over the pairs K8's front-to-back fold tested (its
    # counters), each priced by the listed pairs' exit mix; beside it the
    # bound over every listed pair and over every triangle (the regen
    # route's rays of phase 18, the same rays, every triangle's exit mix)
    k8_mix = {k: sum(n * sh.get(k, 0.0) for n, sh in k8_exits)
              / max(alive_sl, 1) for k in ("det", "u", "whole")}
    sph_flops_ts = alive_all * n_sph_real * FLOPS_PER_PAIR
    k8_flops = sph_flops_ts + tri_flops_sl * alive_all / max(alive_sl, 1)
    k8_tested_flops = sph_flops_ts + k8_pairs * pair_flops(k8_mix)
    k8_every_flops = sph_flops_ts + alive_all * slice_all_flops / slice_rays
    twork["bounce_fwd_list"][0] = k8_tested_flops
    twork_bytes_fwd = twork["bounce_fwd_list"][1]
    twork = {n: (int(w[2]),) + bound(float(w[0]), float(w[1]))
             for n, w in twork.items()}
    before = counts()
    (state_p, _), tfwd_prof_secs, by_key, busy = profiled(
        torch, lambda: tracer_ts.step(tracer_ts.init_state()))
    require(counts()["bounce_fwd_list"] - before["bounce_fwd_list"]
            == twork["bounce_fwd_list"][0], "the profiled pass launched K8 "
            "another number of times than the bounds count")
    require(torch.equal(state_p.mean, mean_ts), "profiled pass image differs")
    k8_ms = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd_list"])
    require(k8_ms > 0, "torch.profiler recorded no K8 device time")
    tfwd_idle = 1.0 - busy / 1e3 / tfwd_prof_secs
    k8_bound = twork["bounce_fwd_list"][1:]
    k8_bytes = twork_bytes_fwd
    k8_bound_listed = bound(k8_flops, k8_bytes)[0]
    k8_bound_every = bound(k8_every_flops, k8_bytes)[0]
    print(f"K8 over the per-sample trimesh pass: {k8_launches} launches, "
          f"{k8_ev_ms:.3f} ms by CUDA events, {k8_ms:.3f} ms under "
          f"torch.profiler (bound {k8_bound[0]:.3f} ms by {k8_bound[1]} "
          f"over the {k8_pairs} pairs tested and {alive_all} alive "
          f"lane-bounces x {n_sph_real} real spheres; "
          f"{k8_bound_listed:.3f} ms over the "
          f"{tri_flops_sl * alive_all / max(alive_sl, 1):.6e} flops of the "
          f"listed pairs, {k8_bound_every:.3f} ms over every triangle); "
          f"list pass rate {pass_rate:.4f} ({folds} tile folds over "
          f"{live_blocks} live block-bounces x {n_tiles_t} tiles, the "
          f"kernel's counters the same); "
          f"profiled pass {tfwd_prof_secs:.3f} s wall, device busy "
          f"{busy:.3f} ms (idle share {tfwd_idle:.3f})", flush=True)
    phase("tri_sample_forward", t0)

    # 24. the per-sample route's forward+backward on trimesh, as a user
    # differentiates it: image_mse(render_mean(..., regen=False), 0)
    # .backward() w.r.t. every sphere leaf, every triangle leaf and the
    # camera, three calls; then one more under torch.profiler
    t0 = time.perf_counter()

    def tri_fwd_bwd_sample():
        for leaf in tleaves:
            leaf.grad = None
        img_g, rays_g = render_mean(tsc, tcm, width=MAIN_W, height=MAIN_H,
                                    spp=TRI_SPP, seed=SEED,
                                    max_bounces=MAX_BOUNCES, backend="fused",
                                    regen=False, return_rays=True)
        image_mse(img_g, target).backward()
        return img_g.detach(), rays_g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0_ts = torch.cuda.memory_allocated()
    reset_counts()
    tsample_secs = []
    t_step = time.perf_counter()
    img_tsg, rays_tsg = tri_fwd_bwd_sample()
    torch.cuda.synchronize()
    tsample_secs.append(time.perf_counter() - t_step)
    launches_ts = counts()
    peak_ts = torch.cuda.max_memory_allocated() - mem0_ts
    require(launches_ts["bounce_fwd_list"] == TRI_SPP * MAX_BOUNCES
            and launches_ts["bounce_replay"] == TRI_SPP * (MAX_BOUNCES - 1)
            and launches_ts["bounce_bwd"] == TRI_SPP * MAX_BOUNCES
            and sum(launches_ts.values()) == TRI_SPP * (3 * MAX_BOUNCES - 1),
            f"per-sample trimesh fwd+bwd launches {launches_ts}")
    require(rays_tsg == rays_ts,
            f"per-sample trimesh fwd+bwd rays {rays_tsg} != {rays_ts}")
    require(torch.equal(img_tsg, mean_ts),
            "per-sample trimesh fwd+bwd image differs from its forward's")
    tsgrads = {k: tsc.leaf(k).grad for k in tsc.leaves}
    tsgrads.update(position=tcm.position.grad, look_at=tcm.look_at.grad)
    for k, g_ in tsgrads.items():
        require(g_ is not None and bool(torch.isfinite(g_).all()),
                f"per-sample trimesh gradient of {k} missing or not finite")
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo", "position"):
        require(tsgrads[k].abs().max().item() > 0,
                f"per-sample trimesh gradient of {k} is zero")
    for _ in range(2):
        t_step = time.perf_counter()
        tri_fwd_bwd_sample()
        torch.cuda.synchronize()
        tsample_secs.append(time.perf_counter() - t_step)
    print(f"per-sample fwd+bwd: trimesh {MAIN_W}x{MAIN_H} {TRI_SPP} spp "
          f"fused --no-regen: {rays_tsg} rays; step {tsample_secs} s = "
          f"{[rays_tsg / t for t in tsample_secs]} rays/s on {card}; "
          f"launches {launches_ts}; peak memory {peak_ts} B above the "
          f"{mem0_ts} B held before", flush=True)
    before = counts()
    (img_tp, _), tstep_prof_secs, by_key, busy = profiled(
        torch, tri_fwd_bwd_sample)
    require(all(counts()[n] - before[n] == w[0] for n, w in twork.items()),
            "the profiled trimesh step's launches differ from the bounds'")
    require(torch.equal(img_tp, mean_ts), "profiled trimesh step differs")
    tstep_tot = {n: (kernel_ms(by_key, BOUNCE_KERNELS[n]),) + w
                 for n, w in twork.items()}
    tstep_idle = 1.0 - busy / 1e3 / tstep_prof_secs
    require(all(v[0] > 0 for v in tstep_tot.values()),
            f"torch.profiler recorded no device time: {tstep_tot}")
    print(f"per-sample trimesh fwd+bwd under torch.profiler: "
          f"{tstep_prof_secs:.3f} s wall, device busy {busy:.3f} ms (idle "
          f"share {tstep_idle:.3f}); "
          + "; ".join(f"{n} {v[0]:.3f} ms over {v[1]} launches (bound "
                      f"{v[2]:.3f} ms by {v[3]})"
                      for n, v in tstep_tot.items()), flush=True)
    phase("tri_sample_fwd_bwd", t0)

    # 24b. the per-sample route on trimesh with tri_list=False, as a caller
    # names it (make_fused_sample(..., tri_list=False), the JAX package's
    # streamed sweep; the CLI has no flag for it): 1920x1080, 2 spp through
    # K4's triangle mode (the spheres culled by their tiles, then every
    # triangle), two calls timed and one under torch.profiler; its image
    # against the listed route's (make_fused_sample's default, the same
    # pixels), at most 20 pixels apart (a list may skip a grazing hit);
    # K4's triangle mode on 1 lane in 32 of sample 0's every bounce
    # against its plain version and the whole launch; its bound over the
    # pairs an exact culled search tests on these rays: the sphere pairs
    # and boxes its own culled search tested (its counters) and the
    # triangle pairs K8's front-to-back fold tests on the same input
    # states (K8's counters; the same winners), priced by the exit mix of
    # phase 22's listed pairs; beside it the bound over every real
    # triangle's pairs, priced by every triangle's exit mix on the regen
    # route's rays (phase 18: the same rays)
    t0 = time.perf_counter()
    ttb_s = fused_tables(tscene,
                         origin_bound(tracer_ts.camera.position[None]))
    tkw4 = dict(use_sky=tscene.use_sky, tri=ttb_s.tri, n_sph=ttb_s.n_sph,
                sph=ttb_s.sph)

    def tri_sample_pass(tri_list):
        fn = make_fused_sample(MAIN_W, MAIN_H, SEED, MAX_BOUNCES,
                               tri_list=tri_list)
        col = torch.zeros((px_all.shape[0], 3), device=dev)
        n = 0
        with torch.no_grad():
            for s_ in range(TRI_SPP):
                c, rc = fn(tscene, tracer_ts.camera, px_all, s_, ttb_s)
                col = col + c
                n = n + rc.sum()
        return col, int(n)

    sweep_secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t_main = time.perf_counter()
        col_off, rays_off = tri_sample_pass(False)
        torch.cuda.synchronize()
        sweep_secs.append(time.perf_counter() - t_main)
        k4t_launches = bounce_fwd.tri_launches
        require(k4t_launches == TRI_SPP * MAX_BOUNCES
                and bounce_fwd.culled_launches == k4t_launches
                and sum(counts().values()) == k4t_launches,
                f"the tri_list=False pass launched {counts()}, "
                f"{k4t_launches} in K4's triangle mode")
    col_on, rays_on = tri_sample_pass(True)
    n_px_off = int((col_off != col_on).any(-1).sum())
    max_px_off = (col_off - col_on).abs().max().item()
    require(bool(torch.isfinite(col_off).all())
            and col_off.mean().item() > 0.01,
            "the tri_list=False image is not finite and non-black")
    require(n_px_off <= 20, f"the tri_list=False image differs from the "
            f"listed route's on {n_px_off} pixels (max {max_px_off}), rays "
            f"{rays_off} vs {rays_on}")
    before = counts()
    (col_pp, _), sweep_prof_secs, by_key, busy = profiled(
        torch, lambda: tri_sample_pass(False))
    require(counts()["bounce_fwd"] - before["bounce_fwd"]
            == TRI_SPP * MAX_BOUNCES, "the profiled tri_list=False pass "
            "launched K4 another number of times")
    require(bits_equal(torch, col_pp, col_off),
            "the profiled tri_list=False pass differs")
    k4t_keys = [k for k in by_key if "bounce_fwd_kernel" in k]
    require(k4t_keys and all("<true>" in k for k in k4t_keys),
            f"the profiled pass's K4 was not the triangle mode: {k4t_keys}")
    k4t_ms = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd"])
    require(k4t_ms > 0, "torch.profiler recorded no K4 triangle-mode time")
    sweep_idle = 1.0 - busy / 1e3 / sweep_prof_secs
    k4t_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    k4t_k8_stats = torch.zeros(3, dtype=torch.int64, device=dev)
    k4t_sl_ms = [0.0, 0.0]           # kernel, plain on the slices
    alive_k4t = k4t_k8_diff = 0
    with torch.no_grad():
        for k in range(TRI_SPP):
            st = init_state(*camera_rays(tracer_ts.camera, MAIN_W, MAIN_H,
                                         px_all, k, SEED))
            for b in range(MAX_BOUNCES):
                alive_k4t += int((st[12] > 0.5).sum())
                sl = st[:, cols].contiguous()
                _, idx_k8 = bounce_fwd_list(st, ttb.table, ttb.tri,
                                            ttb.boxes, b, stats=k4t_k8_stats,
                                            **tkw)
                st, idx = bounce_fwd(st, ttb_s.table, b, stats=k4t_stats,
                                     **tkw4)
                k4t_k8_diff += int((idx_k8 != idx).sum())
                if k:
                    continue
                (out_s, idx_s), ms_k = timed(torch, lambda: bounce_fwd(
                    sl, ttb_s.table, b, **tkw4))
                (out_p, idx_p), ms_p = timed(torch, lambda: bounce_fwd_plain(
                    sl, ttb_s.table, b, **tkw4))
                require(torch.equal(idx_s, idx_p)
                        and bits_equal(torch, out_s, out_p),
                        f"K4 triangle mode, bounce {b}: 1 lane in "
                        f"{SLICE_STRIDE} differs from plain on "
                        f"{int((idx_s != idx_p).sum())} winners")
                require(torch.equal(idx_s, idx[cols])
                        and bits_equal(torch, out_s,
                                       st[:, cols].contiguous()),
                        f"K4 triangle mode, bounce {b}: the slice differs "
                        f"from the launch")
                require(bool((idx_s >= ttb_s.n_sph).any()) or b > 0,
                        "K4's triangle mode found no triangle winner")
                k4t_sl_ms[0] += ms_k
                k4t_sl_ms[1] += ms_p
    require(alive_k4t == rays_off, f"the bounds' bounce loop cast "
            f"{alive_k4t} rays, the tri_list=False pass {rays_off}")
    del st, idx, idx_k8, sl, out_s, out_p
    k4t_boxes, _, k4t_sph_pairs = k4t_stats.tolist()
    k4t_tri_pairs = k4t_k8_stats.tolist()[2]
    k4t_sph_flops = k4t_sph_pairs * FLOPS_PER_PAIR + k4t_boxes * FLOPS_PER_BOX
    k4t_flops = k4t_sph_flops + k4t_tri_pairs * pair_flops(k8_mix)
    k4t_every_flops = k4t_sph_flops + alive_k4t * slice_all_flops / slice_rays
    k4t_bytes = (TRI_SPP * MAX_BOUNCES * (2 * BOUNCE_STATE_BYTES + 4) * r2
                 + ttb_s.table.numel() * 4 + ttb_s.tri.numel() * 4)
    k4t_bound, k4t_by = bound(k4t_flops, k4t_bytes)
    k4t_bound_every = bound(k4t_every_flops, k4t_bytes)[0]
    print(f"per-sample trimesh with tri_list=False (K4's triangle mode): "
          f"{rays_off} rays in {sweep_secs} s on {card}; {k4t_launches} "
          f"launches, K4 {k4t_ms:.3f} ms under torch.profiler (bound "
          f"{k4t_bound:.3f} ms by {k4t_by} over an exact culled search: "
          f"{k4t_tri_pairs} triangle pairs K8 tests on the same states "
          f"(its winners differ on {k4t_k8_diff} lane-bounces), "
          f"{k4t_sph_pairs} sphere pairs and {k4t_boxes} boxes tested; "
          f"{k4t_bound_every:.3f} ms over every real triangle of "
          f"{alive_k4t} alive lane-bounces), idle share {sweep_idle:.3f}; "
          f"against the listed route: rays {rays_off} vs {rays_on}, "
          f"{n_px_off} pixels differ (max |d| {max_px_off}); 1 lane in "
          f"{SLICE_STRIDE} of sample 0 bit-equal to plain and the launch, "
          f"{k4t_sl_ms[0]:.3f} ms kernel / {k4t_sl_ms[1]:.3f} ms plain",
          flush=True)
    phase("tri_sample_sweep", t0)
    kernels["bounce_fwd_tri"] = dict(
        name="bounce_fwd_tri", route="cuda",
        source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1548",
        launches=k4t_launches, max_abs_err=0.0, ms=k4t_ms,
        plain_ms=k4t_sl_ms[1], bound_ms=k4t_bound, bound_by=k4t_by,
        library_ms=None,
        path=f"make_fused_sample(tri_list=False) trimesh {MAIN_W}x{MAIN_H} "
             f"{TRI_SPP} spp",
        shape=f"{TRI_SPP * MAX_BOUNCES} launches of {r2} lanes x "
              f"{ttb_s.n_sph} spheres ({n_sph_real} real, culled) and "
              f"{ttb_s.tri.shape[0]} triangles ({n_tri_real} real), every "
              f"one swept; ms and bound: the whole pass",
        plain_lanes=int(px_all[::SLICE_STRIDE].shape[0]),
        ms_same_lanes=k4t_sl_ms[0], same_lanes="sample 0, 5 bounces",
        bound_every_triangle_ms=k4t_bound_every,
        triangle_pairs_culled=k4t_tri_pairs,
        winners_differing_from_k8=k4t_k8_diff,
        pixels_differing_from_listed=n_px_off)

    path_ts = (f"triangle per-sample: render --scene trimesh fused "
               f"--no-regen {MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    path_tsg = (f"triangle per-sample fwd+bwd: render_mean trimesh fused "
                f"--no-regen {MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    k5t_step, k6t_step = tstep_tot["bounce_replay"], tstep_tot["bounce_bwd"]
    kernels["bounce_fwd_list"] = dict(
        name="bounce_fwd_list", route="cuda",
        source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1824",
        launches=k8_launches, max_abs_err=0.0, ms=k8_ms,
        plain_ms=tslice_ms["bounce_fwd_list"][1], bound_ms=k8_bound[0],
        bound_by=k8_bound[1], library_ms=None, path=path_ts,
        shape=f"{TRI_SPP * MAX_BOUNCES} launches of {r2} lanes x "
              f"{ttb.n_sph} spheres ({n_sph_real} real) and "
              f"{ttb.tri.shape[0]} triangles ({n_tri_real} real) in "
              f"{n_tiles_t} tiles; ms and bound: the whole pass",
        ms_events=k8_ev_ms, list_pass_rate=pass_rate,
        bound_listed_pairs_ms=k8_bound_listed,
        bound_every_triangle_ms=k8_bound_every, pairs_tested=k8_pairs,
        pairs_leaving_at=k8_mix, plain_lanes=tsl_lanes,
        ms_same_lanes=tslice_ms["bounce_fwd_list"][0],
        same_lanes="sample 0, 5 bounces, every 32nd 256-lane block")
    kernels["bounce_replay_tri"] = dict(
        name="bounce_replay_tri", route="cuda",
        source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1871",
        launches=launches_ts["bounce_replay"], max_abs_err=0.0,
        ms=k5t_step[0], plain_ms=tslice_ms["bounce_replay"][1],
        bound_ms=k5t_step[2], bound_by=k5t_step[3], library_ms=None,
        path=path_tsg,
        shape=f"{k5t_step[1]} launches of {r2} lanes; ms and bound: one "
              f"step", plain_lanes=tsl_lanes,
        ms_same_lanes=tslice_ms["bounce_replay"][0],
        same_lanes="sample 0, 4 bounces")
    kernels["bounce_bwd_tri"] = dict(
        name="bounce_bwd_tri", route="cuda",
        source="tpu_ray_torch/csrc/bounce.cu",
        replaces="tpu_ray/kernels/bounce_step.py:1901",
        launches=launches_ts["bounce_bwd"], max_abs_err=k6t_err,
        ms=k6t_step[0], plain_ms=tslice_ms["bounce_bwd"][1],
        bound_ms=k6t_step[2], bound_by=k6t_step[3], library_ms=None,
        path=path_tsg,
        shape=f"{k6t_step[1]} launches of {r2} lanes, {ttb.table.shape[0]} "
              f"table rows; ms and bound: one step",
        plain_lanes=tsl_lanes, ms_same_lanes=tslice_ms["bounce_bwd"][0],
        same_lanes="sample 0, 5 bounces",
        k8_ms_in_step=tstep_tot["bounce_fwd_list"][0], parts=k6t_parts,
        fwd_bwd_peak_bytes=peak_ts, **k6t_merge)

    # 25-29. the flat and Lambert+shadow estimators on K9
    est_kernels, est = estimator_phases(torch, dev, card, reset_counts,
                                        counts, k1_paths)
    kernels.update(est_kernels)
    # K7 also runs in the estimators' backward (the eager estimator); K1's
    # records there are in its paths
    kernels["tri_nearest_hit"]["launches_estimator_bwd"] = {
        "trilight": est_kernels["simple_trace_trilight"][
            "fwd_bwd_launches"]["tri_nearest_hit"]}

    # 30-33. the route past the residency rule: bigmesh on K10
    big_kernels, big = bigmesh_phases(torch, dev, card, reset_counts, counts,
                                      k1_paths)
    kernels.update(big_kernels)
    # K11 on the other steps that differentiate the eager probe: phase 11's
    # backend torch and 21's backend cuda gradients (320x180), the
    # estimators' backward (sixteen, trilight); only these launch it
    require(k11_small["torch"] > 0 and k11_tsmall["cuda"] > 0
            and k11_small["fused"] == k11_small["sample"] == 0
            and k11_tsmall["fused"] == k11_tsmall["sample"] == 0,
            f"K11 launches on the gradient checks: {k11_small}, "
            f"{k11_tsmall}")
    kernels[K11]["paths"].update({
        f"rtweekend backend torch fwd+bwd {CHECK_W}x{CHECK_H} {CHECK_SPP} "
        f"spp": dict(launches=k11_small["torch"]),
        f"trimesh backend cuda fwd+bwd {CHECK_W}x{CHECK_H} {CHECK_SPP} "
        f"spp": dict(launches=k11_tsmall["cuda"]),
        **{f"{label} on fused, fwd+bwd step (the eager estimator's "
           f"backward)": dict(
               launches=est_kernels[key]["fwd_bwd_launches"][K11],
               ms_profiled=est_kernels[key]["fwd_bwd_k11_ms"])
           for key, label in (
               ("simple_trace", "sixteen lambert_shadow {}x{} {} spp"
                .format(*EST_CONFIG2[2:])),
               ("simple_trace_trilight", "trilight lambert_shadow {}x{} {} "
                "spp".format(CHECK_W, CHECK_H, EST_TRILIGHT[4])))}})
    # K7 is K10's reference on bigmesh's states (phase 30)
    kernels["tri_nearest_hit"]["bigmesh"] = {
        f"bounce {b}": {k: c[k] for k in ("k7_ms", "k7_slices", "k7_bound_ms")}
        for b, c in big_kernels["tri_nearest_hit_stream"]["checks"].items()}

    # 34-36. the CLI's resume, --profile, animate, and sharding
    surf_launches, surface = surface_phases(torch, dev, card, reset_counts,
                                            counts, scene)
    for key, fields in surf_launches.items():
        kernels[key].update(fields)

    # 37. the library examples, each at its defaults
    ex_paths, examples = example_phases(torch, dev, card, reset_counts,
                                        counts)
    for key, recs in ex_paths.items():
        kernels[key].setdefault("paths", {}).update(recs)

    for key, rec in k1_paths.items():
        print(f"K1 on {key}: {rec}", flush=True)
    phase("total", t_all)

    print(json.dumps({"main_path": {
        "card": card, "scene": "rtweekend", "width": MAIN_W,
        "height": MAIN_H, "spp": MAIN_SPP, "rays_cast": rays,
        "seconds": secs, "rays_per_s": rays / secs,
        "fwd_bwd_seconds": step_secs,
        "fwd_bwd_rays_per_s": [rays_g / t for t in step_secs],
        "fwd_bwd_peak_bytes": peak,
        "per_sample": {
            "seconds": fwd_secs, "rays_per_s": [rays_s / t for t in fwd_secs],
            "k4_turns_s_ms": {"culled": k4_turns[True],
                              "host_mask": k4_turns[False]},
            "fwd_bwd_seconds": sample_secs,
            "fwd_bwd_rays_per_s": [rays_sg / t for t in sample_secs],
            "fwd_bwd_peak_bytes": peak_s,
            "device_idle_share": {"forward": fwd_idle,
                                  "fwd_bwd": step_idle}},
        "trimesh": {
            "width": MAIN_W, "height": MAIN_H, "spp": TRI_SPP,
            "triangles": n_tri_real, "rays_cast": rays_t,
            "seconds": tri_secs, "rays_per_s": [rays_t / t for t in tri_secs],
            "fwd_bwd_seconds": tri_step_secs,
            "fwd_bwd_rays_per_s": [rays_tg / t for t in tri_step_secs],
            "fwd_bwd_peak_bytes": peak_t,
            "regen_list_pass_rate": k2t_pass,
            "pixels_differing_from_sweep": n_px_sweep,
            "per_sample": {
                "rays_cast": rays_ts, "seconds": tfwd_secs,
                "rays_per_s": [rays_ts / t for t in tfwd_secs],
                "pixels_differing_from_regen": n_px,
                "list_pass_rate": pass_rate,
                "fwd_bwd_seconds": tsample_secs,
                "fwd_bwd_rays_per_s": [rays_tsg / t for t in tsample_secs],
                "fwd_bwd_peak_bytes": peak_ts,
                "device_idle_share": {"forward": tfwd_idle,
                                      "fwd_bwd": tstep_idle},
                "tri_list_off": {
                    "rays_cast": rays_off, "seconds": sweep_secs,
                    "rays_per_s": [rays_off / t for t in sweep_secs],
                    "pixels_differing_from_listed": n_px_off,
                    "device_idle_share": sweep_idle}}},
        "estimators": est, "bigmesh": big, "surface": surface,
        "examples": examples}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
