"""Port parity, the fused estimators (kernels/simple_shade.py: K9's plain
version ``simple_trace_plain``, which the wrapper takes on CPU tensors,
and ``SimpleTrace``, its autograd function) against the JAX package's
``make_simple_trace(..., exact_argmin=True)``, whose Pallas kernel runs
in interpret mode, the frozen estimator goldens and JAX's gradients.

Bounds, with their reasons:
- Plain K9 against JAX's kernel (sixteen and trilight, 32x24, 2 spp from
  sample 3): rays exact; colour sums within rtol 5e-5 / atol 2e-4 and
  within the golden suite's rtol 1e-5 / atol 1e-6 on at least 0.98 of the
  values. The JAX kernel contracts FMAs and approximates rsqrt where the
  port rounds each f32 op, and sixteen's small spheres magnify a hit
  point's rounding into the normal (tests/test_torch_shading_modes.py),
  most where a ray grazes a sphere's silhouette: there the root
  sqrt(r^2 - dsq) is small and carries the rounding of dsq into t.
  Measured: sixteen 25 of 2304 values past the golden bound, 6 past rtol
  5e-5 / atol 2e-5, at most 1.1e-4 absolute (2.6e-4 relative) on sums up
  to ~20; trilight 5 past the golden bound, at most 1.0e-5.
- Goldens through ``render_pass(backend="fused")``: rays exact; every
  value within the golden suite's bound on single-flat, trimesh-flat and
  trilight-lambert (measured max 1.2e-7, 6.0e-8, 1.1e-5 on values near
  1); sixteen-lambert as above, at least 0.99 within it and all within
  rtol 5e-5 / atol 2e-5 (measured 15 values past it, 2.3e-5 relative).
- Lists, slabs and lane slices: bit for bit (the lists only skip tiles
  that hold no hit here; a lane slice takes its full-width block's list).
- Gradients (sixteen and trilight, 32x32, 1 spp, loss sum(img^2) * 1e-3):
  against jax.grad of JAX's render_pass(backend="jnp") within rtol 2e-2 /
  atol 2e-4 per leaf, the bound JAX's own test holds its fused estimator
  to (tests/test_shading_modes.py:252-275); against the port's eager
  route, whose autograd the backward runs, within 1e-5 of each leaf
  group's largest |grad|: the same ops, but the fused route's pixels are
  in tile order, so the sums over rays into each leaf run in another
  order (measured 1.9e-5 absolute on centre gradients up to ~19).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_shading_modes import _tri_light_scene
from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.simple_shade import make_simple_trace as jmake_simple
from tpu_ray.models.path_tracer import render_pass as jrender_pass
from tpu_ray.models.path_tracer import tile_order as jtile_order
from tpu_ray.ops.shading_modes import scene_light_indices as jlights_of

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import (camera_to_numpy, default_camera,
                                       trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, make_trilight_scene,
                                      scene_to_numpy, trainable_scene)
from tpu_ray_torch.kernels.bounce_step import (_block_reach, init_state,
                                               origin_bound)
from tpu_ray_torch.kernels.regen import cam13
from tpu_ray_torch.kernels.simple_shade import (
    SimpleTrace, lane_rows, make_simple_trace, simple_tables,
    simple_trace, simple_trace_plain)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order
from tpu_ray_torch.ops.raygen import film_rays
from tpu_ray_torch.ops.shading_modes import scene_light_indices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
W, H = 32, 24
MODES = {"flat": "flat", "lambert": "lambert_shadow"}


def _scenes(name):
    """(JAX scene, port scene on the CPU)."""
    if name == "trilight":
        return _tri_light_scene(), make_trilight_scene(device="cpu")
    return jmake_scene(name), make_scene(name, device="cpu")


def _bound(scene):
    """The camera's origin bound of the scene's sphere tiles."""
    return origin_bound(default_camera(scene).position[None])


def _close(got, want, min_match, atol=2e-5):
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert ok.mean() >= min_match, ok.mean()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=atol)


@pytest.fixture(scope="module")
def jax_kernel():
    """JAX make_simple_trace (exact argmin, interpret mode) of sixteen and
    trilight: 32x24 tile-ordered lanes, 2 spp from sample 3."""
    px = jtile_order(W, H)[0]
    out = {}
    for name in ("sixteen", "trilight"):
        js, _ = _scenes(name)
        run = jmake_simple(W, H, 0, 2, "lambert_shadow", jlights_of(js),
                           exact_argmin=True)
        color, rays = run(js, jdefault_camera(js), jnp.asarray(px), 3)
        out[name] = (np.asarray(color), int(rays))
    return out


@pytest.mark.parametrize("name", ["sixteen", "trilight"])
def test_plain_matches_jax_kernel(jax_kernel, name):
    _, ts = _scenes(name)
    lights = scene_light_indices(ts)
    tb = simple_tables(ts, lights, _bound(ts))
    px = torch.as_tensor(tile_order(W, H)[0])
    before = simple_trace.launches
    out = simple_trace(lane_rows(px, W, 0), cam13(default_camera(ts), 5),
                       tb["table"], tb["tri"], tb["boxes"], tb["lidx"],
                       tb["ldat"], n_sph=tb["n_sph"], spp=2, s0=3, width=W,
                       height=H, use_sky=tb["use_sky"], flat=False,
                       sph=tb["sph"])
    assert simple_trace.launches == before     # CPU: the plain version
    color, rays = jax_kernel[name]
    assert int(out[3].sum()) == rays
    _close(out[0:3].T.numpy(), color, 0.98, atol=2e-4)


GOLDENS = [("single", "flat", 1.0), ("trimesh", "flat", 1.0),
           ("sixteen", "lambert", 0.99), ("trilight", "lambert", 1.0)]


@pytest.mark.parametrize("name,mode,min_match", GOLDENS,
                         ids=[f"{n}-{m}" for n, m, _ in GOLDENS])
def test_golden_fused_estimators(name, mode, min_match):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-{mode}-fused-exact.npz"))
    _, ts = _scenes(name)
    shading = MODES[mode]
    lights = scene_light_indices(ts) if mode == "lambert" else ()
    img, rays = render_pass(ts, default_camera(ts), width=W, height=H,
                            spp=1, backend="fused", shading=shading,
                            lights=lights)
    assert rays == int(z["rays"])
    _close(img.numpy(), z["image"], min_match)


@pytest.fixture(scope="module")
def trimesh_listed():
    """trimesh flat at 48x32, 1 spp from sample 1: K9's inputs and the
    plain version's output with the primary folds' block lists."""
    ts = make_scene("trimesh", device="cpu")
    tb = simple_tables(ts, (), _bound(ts))
    w, h = 48, 32
    px = torch.as_tensor(tile_order(w, h)[0])
    args = (lane_rows(px, w, 0), cam13(default_camera(ts), 2), tb["table"],
            tb["tri"], tb["boxes"], tb["lidx"], tb["ldat"])
    kw = dict(n_sph=tb["n_sph"], spp=1, s0=1, width=w, height=h,
              use_sky=True, flat=True)
    return args, kw, simple_trace_plain(*args, **kw)


def test_lists_equal_full_sweep_and_cull(trimesh_listed):
    """The primary folds' block lists give the full sweep's output bit for
    bit, and they do skip tiles (the check is not vacuous)."""
    args, kw, listed = trimesh_listed
    swept = simple_trace_plain(*args[:4], None, *args[5:], **kw)
    assert torch.equal(listed, swept)
    assert torch.equal(listed[3], torch.ones_like(listed[3]))
    rows, cam, w, h = args[0], args[1], kw["width"], kw["height"]
    base = rng.sample_base(rng.bits_to_u32(rows[2]), 1)
    d = film_rays(rows[0], rows[1], base, w, h, cam[0:3], cam[3:6],
                  cam[6:9], cam[9:12])
    reach = _block_reach(args[4], init_state(
        cam[0:3].expand(d.shape[0], 3), d, base))
    assert 0 < reach.float().mean() < 0.5


def test_lane_slice_takes_its_blocks_lists(trimesh_listed):
    """simple_trace_plain on a lane slice gives the full run's columns:
    each lane folds its full-width block's list (chip_smoke.py holds K9
    to it on 1 lane in 32)."""
    args, kw, full = trimesh_listed
    lanes = torch.arange(3, args[0].shape[1], 7)
    assert torch.equal(simple_trace_plain(*args, lanes=lanes, **kw),
                       full[:, lanes])


@pytest.mark.parametrize("name,mode", [("trimesh", "flat"),
                                       ("sixteen", "lambert_shadow")])
def test_chunked_equals_unchunked(name, mode, monkeypatch):
    """Chunks give the unchunked pass's image. K9's tables are built once
    for every chunk of a pass, kept for the next pass of the same scene
    and camera, and built anew after a write to either."""
    from tpu_ray_torch.kernels import simple_shade
    built, tables = [], simple_shade.simple_tables

    def counted(*args, **kwargs):
        built.append(1)
        return tables(*args, **kwargs)

    monkeypatch.setattr(simple_shade, "simple_tables", counted)
    monkeypatch.setattr(simple_shade, "_LAST_TABLES", [])
    _, ts = _scenes(name)
    cam = default_camera(ts)
    kw = dict(width=W, height=H, spp=1, sample_start=1, backend="fused",
              shading=mode, lights=scene_light_indices(ts))
    a, ra = render_pass(ts, cam, **kw)
    assert len(built) == 1
    b, rb = render_pass(ts, cam, ray_chunk=W * H // 3, **kw)
    assert len(built) == 1
    assert ra == rb
    assert torch.equal(a, b)
    cam.position.add_(0.0)
    c, rc = render_pass(ts, cam, ray_chunk=W * H // 3, **kw)
    assert len(built) == 2
    ts.albedo.mul_(1.0)
    d, rd = render_pass(ts, cam, **kw)
    assert len(built) == 3
    assert rc == rd == ra
    assert torch.equal(c, a) and torch.equal(d, a)


def test_fused_matches_eager_route():
    """K9's function and the eager estimator reach the same colours in
    other op orders (and the plane-form t for triangles): rays equal,
    colours within rtol 1e-5 / atol 1e-5 (measured 5.7e-6 on sixteen)."""
    for name in ("sixteen", "trilight"):
        _, ts = _scenes(name)
        kw = dict(width=W, height=H, spp=1, sample_start=0,
                  shading="lambert_shadow", lights=scene_light_indices(ts))
        a, ra = render_pass(ts, default_camera(ts), backend="fused", **kw)
        b, rb = render_pass(ts, default_camera(ts), backend="torch", **kw)
        assert ra == rb
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


GW = GH = 32


def _jax_grads(name):
    js, _ = _scenes(name)
    kw = dict(width=GW, height=GH, spp=1, sample_start=0,
              shading="lambert_shadow", lights=jlights_of(js))

    def loss(scene, cam):
        img, _ = jrender_pass(scene, cam, backend="jnp", **kw)
        return jnp.sum(img ** 2) * 1e-3

    gs, gc = jax.grad(loss, argnums=(0, 1))(js, jdefault_camera(js))
    g = {k: np.asarray(getattr(gs, k)) for k in
         ("center", "radius", "albedo", "emissive", "specular", "ior")}
    if gs.tris is not None:
        g.update({f"tris.{k}": np.asarray(getattr(gs.tris, k))
                  for k in ("v0", "e1", "e2", "albedo", "emissive",
                            "specular", "ior")})
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    return g


def _port_grads(name, backend):
    _, ts = _scenes(name)
    sc = trainable_scene(ts)
    cam = trainable_camera(default_camera(ts))
    img, _ = render_pass(sc, cam, width=GW, height=GH, spp=1,
                         backend=backend, shading="lambert_shadow",
                         lights=scene_light_indices(ts))
    (torch.sum(img ** 2) * 1e-3).backward()
    g = scene_to_numpy(sc, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return g


@pytest.mark.parametrize("name", ["sixteen", "trilight"])
def test_simple_trace_grads_match_jax(name):
    want = _jax_grads(name)
    calls = []
    orig = SimpleTrace.backward

    def counted(ctx, *a):
        calls.append(1)
        return orig(ctx, *a)

    SimpleTrace.backward = staticmethod(counted)
    try:
        got = _port_grads(name, "fused")
    finally:
        SimpleTrace.backward = staticmethod(orig)
    assert calls, "the fused route did not run SimpleTrace's backward"
    assert set(got) == set(want)
    nonzero = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2, atol=2e-4,
                                   err_msg=k)
        nonzero += bool(np.abs(want[k]).max() > 0)
    assert nonzero >= 4
    # the lights' centre and emissive rows take gradient
    for li in scene_light_indices(_scenes(name)[1]):
        assert np.abs(got["center"][li]).max() > 0
        assert np.abs(got["emissive"][li]).max() > 0
    eager = _port_grads(name, "torch")
    for k in got:
        np.testing.assert_allclose(
            got[k], eager[k], rtol=0,
            atol=1e-5 * max(np.abs(eager[k]).max(), 1e-6), err_msg=k)


def test_no_grad_runs_the_kernel_alone():
    """Where nothing asks for a gradient the trace is K9 alone (no
    autograd function, no history)."""
    ts = make_scene("single", device="cpu")
    run = make_simple_trace(8, 8, 0, 1, "flat")
    color, rays = run(ts, default_camera(ts), torch.arange(64))
    assert rays == 64 and color.grad_fn is None
    with pytest.raises(ValueError):
        make_simple_trace(8, 8, 0, 1, "path")


def test_bigmesh_estimators_refuse():
    """Past resident_tables_fit (bigmesh) the fused estimators warn that
    they fall back to the streaming route, and render what backends torch
    and cuda render (the eager estimator on the streaming search); K9's
    tables themselves still refuse such a scene."""
    import warnings

    big = make_scene("bigmesh", device="cpu")
    cam = default_camera(big)
    kw = dict(width=8, height=8, spp=1)
    for shading in ("flat", "lambert_shadow"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ref, rays = render_pass(big, cam, backend="torch",
                                    shading=shading, **kw)
            img_c, rays_c = render_pass(big, cam, backend="cuda",
                                        shading=shading, **kw)
        with pytest.warns(UserWarning, match="streaming"):
            img_f, rays_f = render_pass(big, cam, backend="fused",
                                        shading=shading, **kw)
        assert rays == rays_c == rays_f == 64
        assert bool(torch.isfinite(ref).all()) and ref.mean().item() > 0.01
        assert torch.equal(img_c, ref) and torch.equal(img_f, ref)
    with pytest.raises(NotImplementedError, match="probe route"):
        simple_tables(big, (), _bound(big))