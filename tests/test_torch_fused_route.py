"""Port parity, the per-sample fused route as a whole: render_pass(backend
"fused", regen=False) against the JAX package's frozen exact-argmin fused
goldens (tests/goldens/*-fused-exact.npz, 32x24, 1 spp, seed 0), and the
route's own invariants: it renders the bounce loop's image, culling is
bit-identical, slabs and passes compose, the saved records are K4's ids,
the wrappers take their plain versions on CPU tensors, K6's plain version
is the transpose autograd gives.

Golden bounds (tests/test_golden.py:121-123 holds the JAX route to
rtol=1e-5, atol=1e-6): rays exact; rgb and randomized within that bound on
every pixel; rtweekend on >= 0.97 of pixels and everywhere within 2e-3,
the bound test_golden.py:126-134 holds the exact-argmin fused route to
against jnp (XLA's FMA contraction and rsqrt against the port's separately
rounded f32 ops, ROADMAP.md queue C; measured max 1.2e-4).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ray_torch import PathTracer, RenderConfig
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, trainable_scene
from tpu_ray_torch.kernels.bounce_step import (
    bounce_bwd, bounce_bwd_plain, bounce_cull_mask, bounce_fwd,
    bounce_fwd_plain, bounce_replay, bounce_replay_plain, cull_mask,
    fused_tables, init_state, make_fused_sample, morton_perm, origin_bound,
    permute_scene, permute_spheres, ray_block_bounds, scene_table,
    tile_bounds, trace_rays_fused)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order, \
    trace_rays
from tpu_ray_torch.ops.raygen import camera_rays
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
W, H, MB = 32, 24, 5
MIN_MATCH = {"rgb": 1.0, "randomized": 1.0, "rtweekend": 0.97}
FUSED = dict(backend="fused", regen=False)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in MIN_MATCH:
        s = make_scene(name, device="cpu")
        out[name] = (s, default_camera(s))
    return out


@pytest.mark.parametrize("name", list(MIN_MATCH))
def test_golden_fused_exact(scenes, name):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-fused-exact.npz"))
    s, cam = scenes[name]
    img, rays = render_pass(s, cam, width=W, height=H, spp=1, **FUSED)
    img = img.numpy()
    assert rays == int(z["rays"])
    ok = np.isclose(img, z["image"], rtol=1e-5, atol=1e-6).all(axis=-1)
    assert ok.mean() >= MIN_MATCH[name], ok.mean()
    assert np.abs(img - z["image"]).max() < 2e-3


@pytest.mark.parametrize("name", list(MIN_MATCH))
def test_fused_matches_bounce_loop(scenes, name):
    """The same exact search and shading, and the same sample order: the
    per-sample route renders the eager bounce loop's image bit for bit
    (the Morton permutation changes no winner without an exact tie)."""
    s, cam = scenes[name]
    kw = dict(width=W, height=H, spp=2, sample_start=1)
    a, ra = render_pass(s, cam, backend="torch", **kw)
    b, rb = render_pass(s, cam, **FUSED, **kw)
    assert ra == rb
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(MIN_MATCH))
def test_cull_secondary_bit_identical(scenes, name):
    s, cam = scenes[name]
    kw = dict(width=W, height=H, spp=2, **FUSED)
    a, ra = render_pass(s, cam, **kw)
    b, rb = render_pass(s, cam, cull_secondary=True, **kw)
    assert ra == rb
    assert torch.equal(a, b)


def test_ray_chunk_and_passes_compose(scenes):
    """Slabs (each with its own masks) give the unchunked image, and two
    1-spp passes from sample_start 0 and 1 sum to one 2-spp pass."""
    s, cam = scenes["rtweekend"]
    kw = dict(width=W, height=H, **FUSED)
    a, ra = render_pass(s, cam, spp=2, **kw)
    b, rb = render_pass(s, cam, spp=2, ray_chunk=W * H // 4, **kw)
    assert ra == rb and torch.equal(a, b)
    p1, r1 = render_pass(s, cam, spp=1, sample_start=0, **kw)
    p2, r2 = render_pass(s, cam, spp=1, sample_start=1, **kw)
    assert r1 + r2 == ra and torch.equal(p1 + p2, a)


def test_trace_rays_fused_matches_trace_rays(scenes):
    """trace_rays_fused is a drop-in for trace_rays: colour and the
    per-lane rays counter equal."""
    s, cam = scenes["rtweekend"]
    o, d, base = camera_rays(cam, W, H, torch.arange(W * H), 3, 0)
    c0, r0 = trace_rays(s, o, d, base, MB)
    c1, r1 = trace_rays_fused(s, o, d, base, MB, cull_secondary=True)
    assert torch.equal(c0, c1) and torch.equal(r0, r1)


def test_grad_forward_equals_forward_only(scenes):
    """Under autograd the sample renders the forward-only image, and its
    saved records are the int16 winner ids K4 returned, bounce by bounce:
    those of the plain fold with the host's primary cull mask (the
    primary bounce culled, the others not)."""
    s, cam = scenes["rtweekend"]
    px = torch.as_tensor(tile_order(W, H)[0])
    sample = make_fused_sample(W, H, 0, MB)
    c0, r0 = sample(s, cam, px, 2)
    ts = trainable_scene(s)
    c1, r1 = sample(ts, cam, px, 2)
    assert not c0.requires_grad and c1.requires_grad
    assert torch.equal(c0, c1.detach()) and torch.equal(r0, r1)
    stack = c1.grad_fn.saved_tensors[4]
    assert stack.dtype == torch.int16 and stack.shape == (MB, W * H)
    tb = fused_tables(s, origin_bound(cam.position[None]))
    lo, hi = tile_bounds(permute_scene(s))
    st = init_state(*camera_rays(cam, W, H, px, 2, 0))
    for b in range(MB):
        mask = (cull_mask(*ray_block_bounds(st), lo, hi) if b == 0
                else None)
        st, idx = bounce_fwd_plain(st, tb.table, b, mask, use_sky=True)
        assert torch.equal(stack[b], idx.to(torch.int16))
    assert torch.equal(st[9:12].T, c0)


def _chain_state(name, bounces):
    ts = make_scene(name, device="cpu")
    table = scene_table(permute_spheres(ts, morton_perm(ts)))
    px = torch.as_tensor(tile_order(W, H)[0])
    st = init_state(*camera_rays(default_camera(ts), W, H, px, 0, 0))
    for b in range(bounces):
        st, _ = bounce_fwd_plain(st, table, b, use_sky=ts.use_sky)
    out, idx = bounce_fwd_plain(st, table, bounces, use_sky=ts.use_sky)
    return ts, table, st, idx


def _bits(t):
    """Bit patterns: row 13 holds u32 bits, some of them NaN as f32."""
    return t.view(torch.int32)


def test_wrappers_take_plain_on_cpu():
    ts, table, st, idx = _chain_state("rtweekend", 1)
    before = (bounce_fwd.launches, bounce_replay.launches,
              bounce_bwd.launches)
    mask = bounce_cull_mask(ts, st)
    got, want = (bounce_fwd(st, table, 1, mask, use_sky=True),
                 bounce_fwd_plain(st, table, 1, mask, use_sky=True))
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    assert torch.equal(
        _bits(bounce_replay(st, table, idx, 1, use_sky=True)),
        _bits(bounce_replay_plain(st, table, idx, 1, use_sky=True)))
    g = torch.ones_like(st)
    d_out = g.clone()
    d_st, d_tab = bounce_bwd(st, table, idx, 1, d_out, use_sky=True)
    assert d_st is d_out        # in place
    want = bounce_bwd_plain(st, table, idx, 1, g.clone(), use_sky=True)
    assert torch.equal(d_st, want[0]) and torch.equal(d_tab, want[1])
    assert (bounce_fwd.launches, bounce_replay.launches,
            bounce_bwd.launches) == before


@pytest.mark.parametrize("name,bounces", [("rtweekend", 0), ("rtweekend", 2),
                                          ("rgb", 1)])
def test_k6_plain_matches_autograd(name, bounces):
    """bounce_bwd_plain is the transpose of bounce_replay_plain that
    autograd gives: d_state rows 0-11 and d_table within 3e-5 of each
    group's max (the bound tests/test_torch_regen_grad.py holds the shading
    transpose to), on a real chain's state; dead lanes pass the cotangent
    through and rows 12-15 of d_state are zero."""
    ts, table, st, idx = _chain_state(name, bounces)
    g = torch.as_tensor(np.random.default_rng(bounces).standard_normal(
        st.shape).astype(np.float32))
    g[12:16] = 0.0
    st_v = st.clone().requires_grad_()
    tb_v = table.clone().requires_grad_()
    out = bounce_replay_plain(st_v, tb_v, idx, bounces, use_sky=ts.use_sky)
    d_st_ref, d_tab_ref = torch.autograd.grad(out, (st_v, tb_v), g)
    d_st, d_tab = bounce_bwd_plain(st, table, idx, bounces, g.clone(),
                                   use_sky=ts.use_sky)
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)):
        want = d_st_ref[rows]
        torch.testing.assert_close(d_st[rows], want, rtol=3e-5,
                                   atol=3e-5 * float(want.abs().max()))
    torch.testing.assert_close(d_tab, d_tab_ref, rtol=3e-5,
                               atol=3e-5 * float(d_tab_ref.abs().max()))
    dead = (st[12] < 0.5) & (idx < 0)
    assert torch.equal(d_st[0:12, dead], g[0:12, dead])
    assert not d_st[12:16].any()


def test_path_tracer_fused_no_regen():
    cfg = RenderConfig(scene="rgb", width=W, height=H, spp=1,
                       backend="fused", regen=False, cull_secondary=True,
                       exact_argmin=True)
    tracer = PathTracer(cfg, device="cpu")
    state, rays = tracer.render(passes=2)
    ref, ref_rays = render_pass(tracer.scene, tracer.camera, width=W,
                                height=H, spp=2, backend="torch")
    assert state.samples == 2 and rays == ref_rays
    torch.testing.assert_close(state.mean, ref / 2.0, rtol=1e-6, atol=1e-7)


def test_cli_render_fused_no_regen(tmp_path):
    out = tmp_path / "x.png"
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch.cli", "render", "--device",
         "cpu", "--scene", "rtweekend", "--width", str(W), "--height",
         str(H), "--spp", "1", "--backend", "fused", "--no-regen",
         "--cull-secondary", "--exact-argmin", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == W
    assert int.from_bytes(data[20:24], "big") == H
    z = np.load(os.path.join(GOLDEN_DIR, "rtweekend-fused-exact.npz"))
    assert f"{int(z['rays'])} rays" in p.stderr
