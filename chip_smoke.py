#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from tpu_ray_torch/csrc with nvcc,
holds each against its plain PyTorch version on the card, renders with the
sphere-search kernel (held against the same render with the plain search),
then drives the main path as the CLI does: rtweekend at 1920x1080, 64 spp,
backend fused + regen. The main path's own regen state is then run through
the kernel again, which must give the main path's image, and every 32nd
lane of it is held bit for bit against the plain version over all 320
steps. Then the forward+backward main path, as a user differentiates it:
image_mse(grad.render_mean(...), 0).backward() w.r.t. every scene leaf and
the camera, three calls, through K2's recording mode and the K3 backward;
K2-record is held against the forward-only K2 and (1 lane in 32) its plain
version, K3 at the main path's own records against its plain version on
1 lane in 32; the fused gradients against backend torch autograd at
320x180; two make_train_step steps at full size. Then the per-sample fused
route (backend fused without regen) at the same size: K4, K5 and K6 at
the route's own inputs (the main camera's sample 0, 1 lane in 32, and K6
also on all lanes) against their plain versions, a forward pass as the
CLI drives it (and the same samples without the Morton permutation, which
must give the regen route's image bit for bit), three forward+backward
steps as a user differentiates it, one more of each under torch.profiler
for the kernels' device times and the device's idle share (the kernels'
bounds are counted from the same samples outside those calls), and the
route's gradients against the regen route's at 320x180. Then the triangle
scenes: K7 (the triangle search of backend cuda) against its plain version
on trimesh's primary rays and backend cuda's trimesh render against
backend torch's; the triangle main path, trimesh (10,242 triangles) at
1920x1080, 2 spp on fused + regen as the CLI drives it (two calls; K2's
triangle mode at the path's own state, 1 lane in 32 bit for bit against
its plain version), forward and backward as a user differentiates it
(three calls; K2-record, and K3's triangle branch at the path's own
records against its plain version on 1 lane in 32, two K3 launches
bit-equal), and its gradients against backend cuda autograd at 320x180.
Prints each phase's wall seconds, a
JSON line of main-path numbers, one JSON line of per-kernel numbers and,
last, one JSON line with the device. Any failed check raises, so the exit
code is nonzero; without a CUDA device, or without the tpu_ray_torch
package beside this file, it exits nonzero before printing any result.
"""
from __future__ import annotations

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
# one ray-triangle test of csrc/common.cuh trt_tri_hit, by the stage at
# which the pair leaves it: 9 (pvec) + 5 (det) for a pair that fails the
# det test; + 1 (1/det) + 3 (tvec) + 6 (u) for one that fails the u test;
# + 9 (qvec) + 6 (v) + 6 (t) + 1 (u + v) for one that goes through
MT_FLOPS_DET, MT_FLOPS_U, MT_FLOPS_WHOLE = 14, 24, 46
TRI_BYTES = 36            # v0, e1, e2 of one triangle in the search table
STATE_BYTES = 24 * 4      # one lane of the regen state
SPHERE_BYTES = 48         # center, radius, albedo, emissive, specular, ior

SEED = 0
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


def bound(flops: float, nbytes: float):
    """Least time of the work: the larger of its fp32 operations over the
    fp32 peak and its bytes over the memory rate -> (ms, bound_by)."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def mt_work(torch, tab, origin, direction):
    """fp32 operations trt_tri_hit must spend on every pair of these rays
    [R,3] and the triangles of nonzero size in the search table tab [M,9],
    each pair charged by the stage at which it leaves the test ->
    (flops, {stage: share of the pairs}). Repeats the op order of
    ops/intersect_tri.py _mt_slab, so each pair leaves where the kernel's
    does."""
    real = tab[(tab[:, 3:9] != 0).any(dim=1)]
    v0x, v0y, v0z = (real[None, :, k] for k in range(3))
    e1x, e1y, e1z = (real[None, :, k] for k in range(3, 6))
    e2x, e2y, e2z = (real[None, :, k] for k in range(6, 9))
    n_ok = n_whole = 0
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
        n_ok += int(ok.sum())
        n_whole += int((ok & (u >= 0.0)).sum())
    pairs = origin.shape[0] * real.shape[0]
    flops = ((pairs - n_ok) * MT_FLOPS_DET + (n_ok - n_whole) * MT_FLOPS_U
             + n_whole * MT_FLOPS_WHOLE)
    shares = dict(det=(pairs - n_ok) / pairs, u=(n_ok - n_whole) / pairs,
                  whole=n_whole / pairs) if pairs else {}
    return flops, shares


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def k4_work(torch, state, table, mask, block_r, block_n):
    """(fp32 operations, bytes) K4's launch must spend on these inputs:
    each alive lane tests the real spheres of the tiles its block keeps
    (FLOPS_PER_PAIR each); the state is read and written once, the ids
    written, the table read. Device scalars (no synchronisation)."""
    r = state.shape[1]
    alive = torch.nn.functional.pad((state[12] > 0.5).double(),
                                    (0, -r % block_r))
    per_block = alive.view(-1, block_r).sum(1)
    real = torch.nn.functional.pad((table[:, 3] > 0).double(),
                                   (0, -table.shape[0] % block_n))
    per_tile = real.view(-1, block_n).sum(1)
    kept = (per_tile.sum().expand_as(per_block) if mask is None
            else mask.double() @ per_tile)
    flops = (per_block * kept).sum() * FLOPS_PER_PAIR
    return flops, (2 * BOUNCE_STATE_BYTES + 4) * r + table.numel() * 4


# the CUDA kernels of each bounce wrapper, as torch.profiler names them
# (K6 is two launches: the per-block partials, then their fixed-order sum)
BOUNCE_KERNELS = {"bounce_fwd": ("bounce_fwd_kernel",),
                  "bounce_replay": ("bounce_replay_kernel",),
                  "bounce_bwd": ("bounce_bwd_kernel", "sum_parts_kernel")}


def profiled(torch, fn):
    """(fn(), wall s, {kernel key: device ms}, device busy ms) of one call
    under torch.profiler, which reads each kernel's time on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_key = {e.key: e.self_device_time_total / 1e3
              for e in prof.key_averages()}
    return out, wall, by_key, sum(by_key.values())


def kernel_ms(by_key, names) -> float:
    """Device ms of the profiled kernels whose name contains one of names."""
    return sum(ms for key, ms in by_key.items()
               if any(n in key for n in names))


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
        BLOCK_N, BLOCK_R, bounce_bwd, bounce_bwd_plain, bounce_cull_mask,
        bounce_cull_mask_octant, bounce_fwd, bounce_fwd_plain, bounce_replay,
        bounce_replay_plain, fused_tables, init_state, morton_perm,
        permute_spheres, tri_morton_perm)
    from tpu_ray_torch.kernels.regen import (
        SEG_MAX, regen_bwd, regen_bwd_plain, regen_record, regen_steps,
        regen_steps_plain, regen_tables, wave_init)
    from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                        sphere_nearest_hit)
    from tpu_ray_torch.kernels.tri_intersect import (tri_hit_plain,
                                                     tri_nearest_hit)
    from tpu_ray_torch.models.path_tracer import (render_pass, tile_order,
                                                  untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.intersect_tri import tri_search_table
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.utils.png import write_png

    counted = (sphere_nearest_hit, regen_steps, regen_record, regen_bwd,
               bounce_fwd, bounce_replay, bounce_bwd, tri_nearest_hit)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

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
    # the bounds count the spheres of nonzero radius: padding never hits
    n_real = int((scene.radius > 0).sum())
    cam = default_camera(scene)
    kernels = {}

    # 3. K1 against its plain version: 2^16 random rays x rtweekend
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
    hk = sphere_nearest_hit(scene.center, scene.radius, o_t, d_t)
    hp = nearest_hit_plain(scene.center, scene.radius, o_t, d_t)
    torch.cuda.synchronize()
    hit_k, hit_p = hk.t < 1e29, hp.t < 1e29
    require(torch.equal(hit_k, hit_p), "K1: hit masks differ")
    agree = hk.idx == hp.idx
    frac = agree.float().mean().item()
    require(frac >= 0.999, f"K1: idx agrees on {frac} < 0.999 of rays")
    both = hit_k & agree
    rel = ((hk.t - hp.t)[both].abs() / hp.t[both]).max().item() \
        if both.any() else 0.0
    require(rel <= 1e-5, f"K1: t relative error {rel} > 1e-5")
    print(f"K1 check, random rays: idx agree {frac}, max rel |dt| {rel}, "
          f"bit-equal {torch.equal(hk.t, hp.t) and torch.equal(hk.idx, hp.idx)}",
          flush=True)
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
    print(f"K2 check, {CHECK_W}x{CHECK_H} {CHECK_SPP} spp: rays {rays_k}, "
          f"image mean |d| {mean_d}, max |d| {max_d}, state bit-equal",
          flush=True)
    phase("k2_check", t0)

    # 5. the K1 path: render through K1 inside the bounce loop (backend
    # cuda), held against the same render with the plain search
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
    # K1 at the shape that path gives it: one bounce of every pixel
    o1, d1, _ = camera_rays(cam, CHECK_W, CHECK_H, torch.arange(
        CHECK_W * CHECK_H, device=dev), 0, SEED)
    hk = sphere_nearest_hit(scene.center, scene.radius, o1, d1)
    hp = nearest_hit_plain(scene.center, scene.radius, o1, d1)
    require(torch.equal(hk.idx, hp.idx), "K1: primary-ray idx differ")
    k1_err = (hk.t - hp.t).abs().max().item()
    require(k1_err <= 1e-5 * hp.t[hp.t < 1e29].max().item(),
            f"K1: primary-ray max |dt| {k1_err}")
    r1 = o1.shape[0]
    k1_ms = cuda_ms(torch, lambda: sphere_nearest_hit(
        scene.center, scene.radius, o1, d1), 20)
    k1_plain = cuda_ms(torch, lambda: nearest_hit_plain(
        scene.center, scene.radius, o1, d1), 5)
    k1_bound, k1_by = bound(r1 * n_real * FLOPS_PER_PAIR,
                            r1 * 32 + n_real * 16)
    kernels["sphere_nearest_hit"] = dict(
        name="sphere_nearest_hit", route="cuda",
        source="tpu_ray_torch/csrc/sphere_intersect.cu",
        replaces="tpu_ray/kernels/sphere_intersect.py:204",
        launches=k1_launches, max_abs_err=k1_err, ms=k1_ms,
        plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
        library_ms=None,
        path=f"render backend=cuda {CHECK_W}x{CHECK_H} {CHECK_SPP} spp",
        shape=f"{r1} rays x {scene.n_pad} spheres ({n_real} real)")
    print(f"backend cuda: {rays} rays, K1 launches {k1_launches}, image "
          f"equal to backend torch; K1 {k1_ms:.4f} ms / plain "
          f"{k1_plain:.4f} ms at {r1} rays", flush=True)
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
    st_k = st0.clone()
    _, k2_ms = timed(torch, lambda: regen_steps(st_k, c13, table, steps,
                                                **kwm))
    rays_k = int(st_k[22].to(torch.int64).sum())
    require(rays_k == rays, f"K2 launch rays {rays_k} != main path {rays}")
    again = accumulate(tracer.init_state(), untile_image(
        st_k[16:19].T, MAIN_W, MAIN_H, inv), MAIN_SPP)
    require(torch.equal(again.mean, mean),
            "K2 launch image differs from the main path's")
    cols = slice(None, None, SLICE_STRIDE)
    sl_k, sl_p = st0[:, cols].contiguous(), st0[:, cols].contiguous()
    _, k2_ms_slice = timed(torch, lambda: regen_steps(sl_k, c13, table, steps,
                                                      **kwm))
    _, k2_plain = timed(torch, lambda: regen_steps_plain(sl_p, c13, table,
                                                         steps, **kwm))
    require(bits_equal(torch, sl_k, st_k[:, cols]),
            "K2 on the lane slice differs from the whole launch")
    require(torch.equal(sl_p[22], sl_k[22]), "K2: slice rays counter differs")
    k2_err = (sl_p[16:19] - sl_k[16:19]).abs().max().item()
    require(bits_equal(torch, sl_p, sl_k),
            f"K2: slice state not bit-equal to plain (image max |d| {k2_err})")
    # the bound counts the search alone: leaving out the shading and the
    # regeneration of each step only lowers it
    k2_bound, k2_by = bound(rays * n_real * FLOPS_PER_PAIR,
                            2 * STATE_BYTES * r2 + n_real * SPHERE_BYTES + 52)
    kernels["regen_steps"] = dict(
        name="regen_steps", route="cuda", source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:868",
        also_replaces="tpu_ray/kernels/regen.py:769",
        launches=k2_launches, max_abs_err=k2_err, ms=k2_ms,
        plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
        library_ms=None,
        path=f"main: render fused+regen {MAIN_W}x{MAIN_H} {MAIN_SPP} spp",
        shape=f"{r2} lanes x {steps} steps, {rays} rays",
        plain_lanes=sl_p.shape[1], ms_same_lanes=k2_ms_slice)
    print(f"K2 at the main path: {k2_ms:.3f} ms (bound {k2_bound:.3f} ms by "
          f"{k2_by}); 1 lane in {SLICE_STRIDE} ({sl_p.shape[1]}) "
          f"bit-equal to plain, {k2_ms_slice:.3f} ms kernel / "
          f"{k2_plain:.3f} ms plain on those lanes", flush=True)
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
                                                     seg, **kwm))
    require(bits_equal(torch, st_r, st_k),
            "K2-record state differs from the forward-only K2's")
    sl_r, sl_pr = st0[:, cols].contiguous(), st0[:, cols].contiguous()
    recs_s, k2r_ms_slice = timed(torch, lambda: regen_record(
        sl_r, c13, table, steps, seg, **kwm))
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
        rays * n_real * FLOPS_PER_PAIR,
        2 * STATE_BYTES * r2 + n_real * SPHERE_BYTES + 52 + rec_bytes)
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
              f"{n_chk} lane checkpoints",
        forward_only_ms=k2_ms, plain_lanes=sl_pr.shape[1],
        ms_same_lanes=k2r_ms_slice)
    print(f"K2-record at the main path: {k2r_ms:.3f} ms against K2 "
          f"forward-only {k2_ms:.3f} ms (bound {k2r_bound:.3f} ms by "
          f"{k2r_by}); state bit-equal to forward-only; 1 lane in "
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
        stash_bytes=2 * 48 * int(t_end_l.sum()))
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
    small = {}
    for route, backend, regen in (("fused", "fused", True),
                                  ("torch", "torch", False),
                                  ("sample", "fused", False)):
        s2 = trainable_scene(scene)
        c2 = trainable_camera(tracer.camera)
        img2 = render_mean(s2, c2, width=CHECK_W, height=CHECK_H,
                           spp=CHECK_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                           backend=backend, regen=regen)
        image_mse(img2, torch.zeros_like(img2)).backward()
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
    # after bounce (launches not counted). K4 bit-equal to plain, culled
    # (the primary mask at bounce 0, the octant mask after) and not; K5
    # bit-equal to K4; K6's d_state equal to plain, d_table within 1e-4 of
    # each group's max of the plain f64 sum, two launches bit-equal
    t0 = time.perf_counter()
    ftb = fused_tables(scene)
    scene_p = permute_spheres(scene, morton_perm(scene))
    use_sky = scene.use_sky
    px_sl = torch.as_tensor(perm[::SLICE_STRIDE].copy(), device=dev)
    st = init_state(*camera_rays(tracer.camera, MAIN_W, MAIN_H, px_sl, 0,
                                 SEED))
    slice_ms = {"bounce_fwd": [0.0, 0.0], "bounce_replay": [0.0, 0.0],
                "bounce_bwd": [0.0, 0.0]}     # kernel, plain
    states, idxs = [], []
    for b in range(MAX_BOUNCES):
        mask = (bounce_cull_mask if b == 0 else bounce_cull_mask_octant)(
            scene_p, st)
        (out_k, idx_k), _, by_key, _ = profiled(torch, lambda: bounce_fwd(
            st, ftb.table, b, use_sky=use_sky))
        ms_k = kernel_ms(by_key, BOUNCE_KERNELS["bounce_fwd"])
        (out_p, idx_p), ms_p = timed(torch, lambda: bounce_fwd_plain(
            st, ftb.table, b, use_sky=use_sky))
        out_kc, idx_kc = bounce_fwd(st, ftb.table, b, mask, use_sky=use_sky)
        out_pc, idx_pc = bounce_fwd_plain(st, ftb.table, b, mask,
                                          use_sky=use_sky)
        torch.cuda.synchronize()
        for name, o_, i_ in (("plain", out_p, idx_p), ("culled", out_kc,
                                                         idx_kc),
                             ("plain culled", out_pc, idx_pc)):
            require(torch.equal(i_, idx_k) and bits_equal(torch, o_, out_k),
                    f"K4 bounce {b}: {name} differs from the kernel")
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
          f"{SLICE_STRIDE} ({n_sl} lanes), sample 0: K4 bit-equal to plain "
          f"culled and unculled, K5 bit-equal to K4, K6 d_state equal to "
          f"plain and d_table within 1e-4 (max |d| {k6_err}), two K6 "
          f"launches bit-equal; kernel / plain ms {slice_ms}", flush=True)
    del states, idxs, st, d, out_k, out_p, out_kc, out_pc, rep, rep_p

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
        masks = ([bounce_cull_mask(scene_p, st)] if b == 0 else
                 [None, bounce_cull_mask_octant(scene_p, st)])
        out_k, idx_k = bounce_fwd(st, ftb.table, b, masks[0],
                                  use_sky=use_sky)
        for mask in ([None] if b == 0 else []) + masks[1:]:
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
    k6_parts = build.load().trt_bounce_bwd_parts(px_all.shape[0])
    print(f"K4/K5/K6 at the per-sample route's full width, sample 0 "
          f"({px_all.shape[0]} lanes, {k6_parts} K6 blocks): K4 culled "
          f"equal to unculled, K5 "
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
    # counted outside the profiled calls: the route's bounces (the primary
    # culled, the rest not) of every sample again, each launch's alive
    # lanes per block against the real spheres of the tiles it keeps, and
    # the live lanes that K5 (bounces 0..B-2) and K6 (all) shade
    work = {n: [0.0, 0.0, 0] for n in BOUNCE_KERNELS}   # flops, bytes, n
    tab_bytes = ftb.table.numel() * 4
    acc_rays = 0
    with torch.no_grad():
        for k in range(MAIN_SPP):
            st = init_state(*camera_rays(tracer_s.camera, MAIN_W, MAIN_H,
                                         px_all, k, SEED))
            for b in range(MAX_BOUNCES):
                acc_rays = acc_rays + (st[12] > 0.5).sum()
                mask = bounce_cull_mask(scene_p, st) if b == 0 else None
                flops, nbytes = k4_work(torch, st, ftb.table, mask, BLOCK_R,
                                        BLOCK_N)
                st, idx = bounce_fwd(st, ftb.table, b, mask,
                                     use_sky=use_sky)
                live = (idx >= 0).double().sum()
                todo = [("bounce_fwd", flops, nbytes),
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
    work = {n: (int(w[2]),) + bound(float(w[0]), float(w[1]))
            for n, w in work.items()}
    del st, idx
    before = counts()
    (state_t, _), fwd_prof_secs, by_key, busy = profiled(
        torch, lambda: tracer_s.step(tracer_s.init_state()))
    require(counts()["bounce_fwd"] - before["bounce_fwd"]
            == work["bounce_fwd"][0], "the profiled pass launched K4 "
            "another number of times than the bounds count")
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
              f"{scene.n_pad} spheres ({n_real} real); ms and bound: the "
              f"whole pass",
        plain_lanes=n_sl, ms_same_lanes=slice_ms["bounce_fwd"][0],
        same_lanes="sample 0, 5 bounces")
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
    # version, and the path itself: backend cuda's render of trimesh (K1
    # for the sphere, K7 for the triangles, in the eager bounce loop) at
    # 320x180, 4 spp, bit-equal to backend torch's
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
    require(k7_launches > 0 and sphere_nearest_hit.launches > 0,
            f"backend cuda on trimesh did not launch K1 and K7: {counts()}")
    require(sum(counts().values()) == k7_launches
            + sphere_nearest_hit.launches,
            f"backend cuda on trimesh launched others: {counts()}")
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
              f"real), {int(hit7.sum())} hits",
        pairs_leaving_at=k7_exits)
    print(f"backend cuda, trimesh: {rays_c} rays, K7 launches {k7_launches},"
          f" image equal to backend torch; K7 at {r7} primary rays "
          f"bit-equal to plain: {k7_ms:.4f} ms (bound {k7_bound:.4f} ms by "
          f"{k7_by}; pairs leaving the test at {k7_exits}) / plain "
          f"{k7_plain:.4f} ms", flush=True)
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

    # 18. K2's triangle mode at the triangle path's own state (launches not
    # counted): the whole launch, timed, must give the path's image, and
    # every 32nd lane of it is held bit for bit against the plain version
    # over all its steps
    t0 = time.perf_counter()
    ttable, ttri, tn_tri = regen_tables(tscene)
    n_sph = ttable.shape[0] - tn_tri
    tsteps = TRI_SPP * MAX_BOUNCES
    kwt = dict(use_sky=tscene.use_sky, max_bounces=MAX_BOUNCES, width=MAIN_W,
               height=MAIN_H)
    tst0, tc13, tr2 = wave_init(tracer_t.camera, torch.as_tensor(
        perm, device=dev), TRI_SPP, SEED, 0, MAIN_W, MAIN_H)
    tst_k = tst0.clone()
    _, k2t_ms = timed(torch, lambda: regen_steps(tst_k, tc13, ttable, tsteps,
                                                 tri=ttri, **kwt))
    require(int(tst_k[22].to(torch.int64).sum()) == rays_t,
            "K2 triangle launch rays differ from the path's")
    again = accumulate(tracer_t.init_state(), untile_image(
        tst_k[16:19].T, MAIN_W, MAIN_H, inv), TRI_SPP)
    require(torch.equal(again.mean, mean_t),
            "K2 triangle launch image differs from the path's")
    tsl_k, tsl_p = tst0[:, cols].contiguous(), tst0[:, cols].contiguous()
    _, k2t_ms_slice = timed(torch, lambda: regen_steps(
        tsl_k, tc13, ttable, tsteps, tri=ttri, **kwt))
    _, k2t_plain = timed(torch, lambda: regen_steps_plain(
        tsl_p, tc13, ttable, tsteps, tri=ttri, **kwt))
    require(bits_equal(torch, tsl_k, tst_k[:, cols]),
            "K2 triangle mode on the lane slice differs from the launch")
    k2t_err = (tsl_p[16:19] - tsl_k[16:19]).abs().max().item()
    require(bits_equal(torch, tsl_p, tsl_k),
            f"K2 triangle mode: slice not bit-equal to plain (image max |d| "
            f"{k2t_err})")
    # the bound counts the search alone: every sphere of nonzero size, and
    # every triangle of nonzero size charged by where the pair leaves the
    # test, each cast ray. The triangle pairs are counted on the lane
    # slice's own rays, stepped through the plain version one step at a
    # time (which must end where its one call of all steps did), and
    # scaled from the slice's rays to the path's
    cnt_st = tst0[:, cols].contiguous()
    slice_tri_flops, slice_rays, exits = 0, 0, []
    for _ in range(tsteps):
        alive = cnt_st[12] > 0.5
        if bool(alive.any()):
            f, sh = mt_work(torch, ttri, cnt_st[0:3, alive].T,
                            cnt_st[3:6, alive].T)
            slice_tri_flops += f
            slice_rays += int(alive.sum())
            exits.append((int(alive.sum()), sh))
        regen_steps_plain(cnt_st, tc13, ttable, 1, tri=ttri, **kwt)
    require(bits_equal(torch, cnt_st, tsl_p)
            and slice_rays == int(tsl_p[22].to(torch.int64).sum()),
            "the plain version stepped one step at a time differs")
    del cnt_st
    k2t_exits = {k: sum(n * sh[k] for n, sh in exits) / slice_rays
                 for k in ("det", "u", "whole")}
    tri_flops = (rays_t * n_sph_real * FLOPS_PER_PAIR
                 + rays_t * slice_tri_flops / slice_rays)
    tri_bytes = (2 * STATE_BYTES * tr2 + n_sph_real * SPHERE_BYTES
                 + n_tri_real * (TRI_BYTES + SPHERE_BYTES) + 52)
    k2t_bound, k2t_by = bound(tri_flops, tri_bytes)
    path_t = (f"triangle main: render --scene trimesh fused+regen "
              f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    kernels["regen_steps_tri"] = dict(
        name="regen_steps_tri", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:812",
        also_replaces="tpu_ray/kernels/regen.py:868",
        launches=k2t_launches, max_abs_err=k2t_err, ms=k2t_ms,
        plain_ms=k2t_plain, bound_ms=k2t_bound, bound_by=k2t_by,
        library_ms=None, path=path_t,
        shape=f"{tr2} lanes x {tsteps} steps, {rays_t} rays, "
              f"{ttable.shape[0]} primitives ({n_sph_real} spheres and "
              f"{n_tri_real} triangles real)",
        plain_lanes=tsl_p.shape[1], ms_same_lanes=k2t_ms_slice,
        pairs_leaving_at=k2t_exits)
    print(f"K2 triangle mode at the triangle path: {k2t_ms:.3f} ms (bound "
          f"{k2t_bound:.3f} ms by {k2t_by}; triangle pairs leaving the test "
          f"at {k2t_exits}); 1 lane in {SLICE_STRIDE} "
          f"({tsl_p.shape[1]}) bit-equal to plain, {k2t_ms_slice:.3f} ms "
          f"kernel / {k2t_plain:.3f} ms plain on those lanes", flush=True)
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
    # state and records (launches not counted): K2-record leaves the
    # forward-only K2's state and, on 1 lane in 32, the plain version's
    # records; K3 (two launches, bit-equal) at the main loss's cotangent:
    # its d_table against the path's gradients, and on 1 lane in 32
    # d_state equal to plain, d_table and d_cam within 1e-4 of each
    # group's max of the plain f64 sum (sphere and triangle rows apart)
    t0 = time.perf_counter()
    seg_t = min(SEG_MAX, tsteps)
    tst_r = tst0.clone()
    trecs, k2tr_ms = timed(torch, lambda: regen_record(
        tst_r, tc13, ttable, tsteps, seg_t, tri=ttri, **kwt))
    require(bits_equal(torch, tst_r, tst_k),
            "K2-record triangle state differs from the forward-only K2's")
    tsl_r, tsl_pr = tst0[:, cols].contiguous(), tst0[:, cols].contiguous()
    trecs_s, k2tr_ms_slice = timed(torch, lambda: regen_record(
        tsl_r, tc13, ttable, tsteps, seg_t, tri=ttri, **kwt))
    (_, trecs_p), k2tr_plain = timed(torch, lambda: regen_steps_plain(
        tsl_pr, tc13, ttable, tsteps, seg=seg_t, tri=ttri, **kwt))
    require(bits_equal(torch, tsl_r, tsl_pr),
            "K2-record triangle slice state not bit-equal to plain")
    t_end_p = trecs_p.t_end.long()
    valid = torch.arange(tsteps, device=dev)[:, None] < t_end_p[None, :]
    require(torch.equal(trecs_s.t_end, trecs_p.t_end)
            and torch.equal(trecs_s.rec[valid], trecs_p.rec[valid]),
            "K2-record triangle records differ from plain")
    require(bool((trecs_p.rec[valid] >= n_sph).any()),
            "the triangle path recorded no triangle winner")
    n_chk_t = int(((trecs.t_end.long() + seg_t - 1) // seg_t).sum())
    k2tr_bound, k2tr_by = bound(
        tri_flops, tri_bytes + 2 * rays_t + STATE_BYTES * n_chk_t + 4 * tr2)
    path_tg = (f"triangle main fwd+bwd: render_mean trimesh fused+regen "
               f"{MAIN_W}x{MAIN_H} {TRI_SPP} spp")
    kernels["regen_record_tri"] = dict(
        name="regen_record_tri", route="cuda",
        source="tpu_ray_torch/csrc/regen.cu",
        replaces="tpu_ray/kernels/regen.py:812",
        also_replaces="tpu_ray/kernels/regen.py:868",
        launches=launches_t["regen_record"], max_abs_err=0.0, ms=k2tr_ms,
        plain_ms=k2tr_plain, bound_ms=k2tr_bound, bound_by=k2tr_by,
        library_ms=None, path=path_tg,
        shape=f"{tr2} lanes x {tsteps} steps, seg {seg_t}, {rays_t} rays",
        forward_only_ms=k2t_ms, plain_lanes=tsl_pr.shape[1],
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
        partial_bytes=build.load().trt_regen_bwd_parts(tr2)
        * ttable.numel() * 4)
    print(f"K2-record triangle mode: {k2tr_ms:.3f} ms (forward-only "
          f"{k2t_ms:.3f} ms), state bit-equal to forward-only, 1 lane in "
          f"{SLICE_STRIDE}: records equal to plain; K3 triangle branch at "
          f"the triangle path: {k3t_ms:.3f} ms (bound {k3t_bound:.3f} ms by "
          f"{k3t_by}), two launches bit-equal, d_table equal to the path's "
          f"within 1e-4; 1 lane in {SLICE_STRIDE}: d_state equal to plain, "
          f"d_table and d_cam within 1e-4 of each group's max (max |d| "
          f"{k3t_err}), {k3t_ms_slice:.3f} ms kernel / {k3t_plain:.3f} ms "
          f"plain", flush=True)
    phase("k3_tri_check", t0)
    del trecs, trecs_s, trecs_p, trecs_sl, tst_r

    # 21. the triangle path's gradients against backend cuda autograd
    # (the eager route: Möller-Trumbore payload, K1 and K7 searches) on
    # trimesh at 320x180, 4 spp: each group within 3e-3 of its max
    t0 = time.perf_counter()
    tsmall = {}
    for backend in ("fused", "cuda"):
        s2 = trainable_scene(tscene)
        c2 = trainable_camera(tcam)
        img2 = render_mean(s2, c2, width=CHECK_W, height=CHECK_H,
                           spp=CHECK_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                           backend=backend, regen=backend == "fused")
        image_mse(img2, torch.zeros_like(img2)).backward()
        tsmall[backend] = {k: s2.leaf(k).grad for k in s2.leaves}
        tsmall[backend].update(position=c2.position.grad,
                               look_at=c2.look_at.grad)
    tri_rel = {}
    for k, b in tsmall["cuda"].items():
        a = tsmall["fused"][k]
        tri_rel[k] = ((a - b).abs().max()
                      / b.abs().max().clamp_min(1e-12)).item()
        require(tri_rel[k] < 3e-3 or b.abs().max().item() == 0.0
                and a.abs().max().item() == 0.0,
                f"trimesh fused grad {k} differs from cuda by {tri_rel[k]}")
    print(f"trimesh fused+regen vs backend cuda autograd gradients, "
          f"{CHECK_W}x{CHECK_H} {CHECK_SPP} spp: max relative per group "
          f"{tri_rel}", flush=True)
    phase("tri_grad_check", t0)

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
            "fwd_bwd_peak_bytes": peak_t}}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
