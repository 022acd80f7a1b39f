"""Port parity, whole slice: tpu_ray_torch's render_pass against the JAX
package's frozen goldens (tests/goldens, 32x24, 1 spp, seed 0), plus the
port's own invariants (chunking, progressive passes, CLI, no JAX imports).

Golden bounds (tests/test_golden.py:25-26,122 hold jnp to rtol=1e-5,
atol=1e-6): rays are exact on every backend; rgb and randomized images
match within that bound on every pixel; rtweekend within it on >= 0.97 of
pixels and everywhere within 2e-3, because XLA contracts FMAs and
approximates rsqrt where the port rounds every f32 op on its own, and the
dielectric and small-sphere bounces of rtweekend magnify those 1-ulp
differences (ROADMAP.md queue C). The fused+regen route is held to the
regen-exact golden within 2e-3, the bound the JAX package holds its
exact-argmin fused route to against jnp (test_golden.py:126-134).
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ray_torch import PathTracer, RenderConfig
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.models.path_tracer import (render_pass, tile_order,
                                              untile_image)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
W, H = 32, 24
MIN_MATCH = {"rgb": 1.0, "randomized": 1.0, "rtweekend": 0.97}


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in MIN_MATCH:
        s = make_scene(name, device="cpu")
        out[name] = (s, default_camera(s))
    return out


def _render(scenes, name, **kw):
    s, cam = scenes[name]
    img, rays = render_pass(s, cam, width=W, height=H, spp=1, **kw)
    return img.numpy(), rays


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(MIN_MATCH))
def test_golden(scenes, name, backend):
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    img, rays = _render(scenes, name, backend=backend)
    assert rays == int(z["rays"])
    ok = np.isclose(img, z["image"], rtol=1e-5, atol=1e-6).all(axis=-1)
    assert ok.mean() >= MIN_MATCH[name], ok.mean()
    assert np.abs(img - z["image"]).max() < 2e-3


def test_golden_regen_exact(scenes):
    z = np.load(os.path.join(GOLDEN_DIR, "rtweekend-regen-exact.npz"))
    img, rays = _render(scenes, "rtweekend", backend="fused", regen=True)
    assert rays == int(z["rays"])
    assert np.abs(img - z["image"]).max() < 2e-3


@pytest.mark.parametrize("name", list(MIN_MATCH))
def test_regen_matches_bounce_loop(scenes, name):
    """Same exact search and shading, per-pixel sample order kept: the
    persistent wavefront renders the per-sample bounce loop's image."""
    s, cam = scenes[name]
    kw = dict(width=W, height=H, spp=2, sample_start=0)
    a, ra = render_pass(s, cam, backend="torch", **kw)
    b, rb = render_pass(s, cam, backend="fused", regen=True, **kw)
    assert ra == rb
    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("backend,regen", [("torch", False),
                                           ("fused", True)])
def test_ray_chunk_same_result(scenes, backend, regen):
    s, cam = scenes["rtweekend"]
    kw = dict(width=W, height=H, spp=2, backend=backend, regen=regen)
    a, ra = render_pass(s, cam, **kw)
    b, rb = render_pass(s, cam, ray_chunk=W * H // 4, **kw)
    assert ra == rb
    assert torch.equal(a, b)


@pytest.mark.parametrize("backend,regen", [("torch", False),
                                           ("fused", True)])
def test_progressive_passes_continue_the_streams(scenes, backend, regen):
    """Two 1-spp passes from sample_start 0 and 1 sum to one 2-spp pass."""
    s, cam = scenes["rgb"]
    kw = dict(width=W, height=H, backend=backend, regen=regen)
    p1, r1 = render_pass(s, cam, spp=1, sample_start=0, **kw)
    p2, r2 = render_pass(s, cam, spp=1, sample_start=1, **kw)
    both, rb = render_pass(s, cam, spp=2, sample_start=0, **kw)
    assert r1 + r2 == rb
    assert torch.equal(p1 + p2, both)


def test_tile_order_round_trip():
    perm, inv = tile_order(70, 40)
    assert sorted(perm.tolist()) == list(range(70 * 40))
    img = torch.arange(70 * 40 * 3, dtype=torch.float32).reshape(-1, 3)
    assert torch.equal(untile_image(img[torch.as_tensor(perm)], 70, 40, inv),
                       img.reshape(40, 70, 3))


def test_path_tracer_accumulates():
    cfg = RenderConfig(scene="rgb", width=W, height=H, spp=1,
                       backend="fused", regen=True)
    tracer = PathTracer(cfg, device="cpu")
    state, rays = tracer.render(passes=2)
    assert state.samples == 2 and rays > 2 * W * H
    img = tracer.srgb_image(state)
    assert img.shape == (H, W, 4) and img.dtype == torch.uint8
    assert int(img[..., :3].max()) > 0


@pytest.mark.parametrize("kw", [dict(backend="fused", shading="flat"),
                                dict(backend="torch", shading="flat"),
                                dict(backend="torch",
                                     shading="lambert_shadow")])
def test_unported_routes_refuse(scenes, kw):
    s, cam = scenes["rgb"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render_pass(s, cam, width=W, height=H, spp=1, **kw)


def test_config_rejects_jax_backend_names():
    with pytest.raises(ValueError):
        RenderConfig(backend="pallas")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "tpu_ray_torch.cli", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_cli_render_writes_png(tmp_path, backend):
    out = tmp_path / "x.png"
    p = _cli("render", "--device", "cpu", "--scene", "rtweekend", "--width",
             str(W), "--height", str(H), "--spp", "1", "--backend", backend,
             "--out", str(out))
    assert p.returncode == 0, p.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == W
    assert int.from_bytes(data[20:24], "big") == H
    assert "1 spp accumulated" in p.stderr


def test_cli_scenes_and_unported_flags(tmp_path):
    p = _cli("scenes")
    assert p.returncode == 0 and "rtweekend" in p.stdout
    p = _cli("render", "--device", "cpu", "--width", "8", "--height", "8",
             "--mesh", "8", "--out", str(tmp_path / "y.png"))
    assert p.returncode == 2 and "unrecognized arguments" in p.stderr
    p = _cli("render", "--device", "cpu", "--width", "8", "--height", "8",
             "--shading", "flat", "--out", str(tmp_path / "y.png"))
    assert p.returncode != 0 and "NotImplementedError" in p.stderr
    assert not (tmp_path / "y.png").exists()


def _port_sources():
    pkg = os.path.join(ROOT, "tpu_ray_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax(path):
    """Neither the port nor chip_smoke.py may import jax or tpu_ray: the
    card's machine has no JAX."""
    with open(path) as f:
        src = f.read()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "tpu_ray"), (path, n)
    assert "import jax" not in src and "tpu_ray." not in src
