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
320x180; two make_train_step steps at full size. Prints each phase's wall
seconds, a JSON line of main-path numbers, one JSON line of per-kernel
numbers and, last, one JSON line with the device. Any failed check
raises, so the exit code is nonzero; without a CUDA device, or without the
tpu_ray_torch package beside this file, it exits nonzero before printing
any result.
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
STATE_BYTES = 24 * 4      # one lane of the regen state
SPHERE_BYTES = 48         # center, radius, albedo, emissive, specular, ior

SEED = 0
CHECK_W, CHECK_H, CHECK_SPP = 320, 180, 4
MAIN_W, MAIN_H, MAIN_SPP, MAX_BOUNCES = 1920, 1080, 64, 5
SLICE_STRIDE = 32         # plain K2 runs on every 32nd lane of the main state
# fp32 operations of one alive lane-step of K3, counted from
# csrc/regen_step.cuh trt_step_tail (replay, ~107 on a diffuse hit) and
# csrc/regen_bwd.cu (shade_vjp's primal recompute ~139 and transpose ~237,
# the regenerated ray's camera transpose ~73), rounded down
K3_FLOPS_PER_STEP = 550


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


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


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
    from tpu_ray_torch.kernels.regen import (
        SEG_MAX, regen_bwd, regen_bwd_plain, regen_record, regen_steps,
        regen_steps_plain, wave_init)
    from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                        sphere_nearest_hit)
    from tpu_ray_torch.models.path_tracer import (render_pass, tile_order,
                                                  untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.intersect import payload_tables
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.utils.png import write_png

    counted = (sphere_nearest_hit, regen_steps, regen_record, regen_bwd)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

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
    table = payload_tables(scene)
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
    require(sphere_nearest_hit.launches == 0 and regen_record.launches == 0
            and regen_bwd.launches == 0, "forward path launched others")
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
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = torch.cuda.max_memory_allocated() - mem0
    require(launches["regen_record"] > 0, "fwd+bwd did not launch K2-record")
    require(launches["regen_bwd"] > 0, "fwd+bwd did not launch K3")
    require(launches["regen_steps"] == 0 and
            launches["sphere_nearest_hit"] == 0,
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
    # the colour total, the whole launch timed; 1 lane in 32 held against
    # the plain version (d_state exactly; d_table and d_cam, summed with
    # f32 atomics in a varying order, within 1e-4 of each group's max of
    # the plain version's f64 sum)
    t0 = time.perf_counter()
    col = st_k[16:19].T.contiguous().requires_grad_()
    image_mse(untile_image(col, MAIN_W, MAIN_H, inv)
              / torch.tensor(float(MAIN_SPP), device=dev), target).backward()
    d_out = torch.zeros_like(st0)
    d_out[16:19] = col.grad.T
    (d_st, d_tab, d_cam), k3_ms = timed(torch, lambda: regen_bwd(
        recs, d_out, c13, table, **kwm))
    scene_cols = dict(center=slice(0, 3), radius=3, albedo=slice(4, 7),
                      emissive=slice(7, 10), specular=10, ior=11)
    for k, c in scene_cols.items():
        want = main_grads[k]
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
          f"by {k3_by}); d_table equal to the fwd+bwd path's within 1e-4; "
          f"1 lane in {SLICE_STRIDE}: d_state equal to plain (bit-equal "
          f"{st_bits}), d_table and "
          f"d_cam within 1e-4 of each group's max (max |d| {k3_err}), "
          f"{k3_ms_slice:.3f} ms kernel / {k3_plain:.3f} ms plain",
          flush=True)
    phase("k3_check", t0)
    del recs, recs_s, recs_p, recs_sl, st_r

    # 11. fused+regen gradients against backend torch autograd at 320x180,
    # 4 spp on the card: each group within 3e-3 of its max
    t0 = time.perf_counter()
    small = {}
    for backend in ("fused", "torch"):
        s2 = trainable_scene(scene)
        c2 = trainable_camera(tracer.camera)
        img2 = render_mean(s2, c2, width=CHECK_W, height=CHECK_H,
                           spp=CHECK_SPP, seed=SEED, max_bounces=MAX_BOUNCES,
                           backend=backend, regen=backend == "fused")
        image_mse(img2, torch.zeros_like(img2)).backward()
        small[backend] = [getattr(s2, k).grad for k in SCENE_LEAVES] + [
            c2.position.grad, c2.look_at.grad]
    small_err = 0.0
    for k, a, b in zip(SCENE_LEAVES + ("position", "look_at"),
                       small["fused"], small["torch"]):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
        small_err = max(small_err, rel)
        require(rel < 3e-3, f"fused grad {k} differs from torch by {rel}")
    print(f"fused+regen vs torch autograd gradients, {CHECK_W}x{CHECK_H} "
          f"{CHECK_SPP} spp: max relative {small_err}", flush=True)
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
    phase("total", t_all)

    print(json.dumps({"main_path": {
        "card": card, "scene": "rtweekend", "width": MAIN_W,
        "height": MAIN_H, "spp": MAIN_SPP, "rays_cast": rays,
        "seconds": secs, "rays_per_s": rays / secs,
        "fwd_bwd_seconds": step_secs,
        "fwd_bwd_rays_per_s": [rays_g / t for t in step_secs],
        "fwd_bwd_peak_bytes": peak}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
