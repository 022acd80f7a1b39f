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
steps. Prints each phase's wall seconds, one JSON line of per-kernel
numbers and, last, one JSON line with the device. Any failed check raises, so the exit code is nonzero; without a
CUDA device, or without the tpu_ray_torch package beside this file, it
exits nonzero before printing any result.
"""
from __future__ import annotations

import json
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
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.core.scene import make_scene
    from tpu_ray_torch.kernels import build
    from tpu_ray_torch.kernels.regen import (regen_steps, regen_steps_plain,
                                             wave_init)
    from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                        sphere_nearest_hit)
    from tpu_ray_torch.models.path_tracer import (render_pass, tile_order,
                                                  untile_image)
    from tpu_ray_torch.ops.accumulate import accumulate
    from tpu_ray_torch.ops.raygen import camera_rays
    from tpu_ray_torch.utils.png import write_png

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
    regen_steps(st_k, c13, scene, CHECK_SPP * MAX_BOUNCES, **kw)
    regen_steps_plain(st_p, c13, scene, CHECK_SPP * MAX_BOUNCES, **kw)
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
    sphere_nearest_hit.launches = 0
    regen_steps.launches = 0
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
    sphere_nearest_hit.launches = 0
    regen_steps.launches = 0
    t_main = time.perf_counter()
    state, rays = tracer.step(state0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t_main
    k2_launches = regen_steps.launches
    require(k2_launches > 0, "main path did not launch K2")
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
    _, k2_ms = timed(torch, lambda: regen_steps(st_k, c13, scene, steps,
                                                **kwm))
    rays_k = int(st_k[22].to(torch.int64).sum())
    require(rays_k == rays, f"K2 launch rays {rays_k} != main path {rays}")
    again = accumulate(tracer.init_state(), untile_image(
        st_k[16:19].T, MAIN_W, MAIN_H, inv), MAIN_SPP)
    require(torch.equal(again.mean, mean),
            "K2 launch image differs from the main path's")
    cols = slice(None, None, SLICE_STRIDE)
    sl_k, sl_p = st0[:, cols].contiguous(), st0[:, cols].contiguous()
    _, k2_ms_slice = timed(torch, lambda: regen_steps(sl_k, c13, scene, steps,
                                                      **kwm))
    _, k2_plain = timed(torch, lambda: regen_steps_plain(sl_p, c13, scene,
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
    phase("total", t_all)

    print(json.dumps({"main_path": {
        "card": card, "scene": "rtweekend", "width": MAIN_W,
        "height": MAIN_H, "spp": MAIN_SPP, "rays_cast": rays,
        "seconds": secs, "rays_per_s": rays / secs}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
