"""Port parity, the library examples: every script of
tpu_ray_torch/examples runs its ``main()`` at the tiny size of
tests/test_examples.py (64x40, 1 spp) on the CPU (``--device cpu``, the
plain versions of the kernels), with that file's assertions; the sharded
example runs in the 2-rank gloo job of tests/test_torch_parallel.py.

Examples 2 and 6 on backend "torch" are held against the JAX scripts'
own ``main()`` at the same flags, to the bounds the port's render tests
hold a glass scene to against JAX: >= 0.97 of the values within rtol
1e-5 / atol 1e-6 (the rtweekend golden, ROADMAP.md queue C), and at most
1 pixel in 512 past 2e-3 (tests/test_torch_parallel.py against JAX's
sharded render). The golden's "every pixel within 2e-3" does not hold
here: on each example one pixel of 2,560 takes another branch (measured:
0.5 on example 2, whose JAX image casts one ray more, and 0.057 on
example 6), where a dielectric or a grazing exit from the radius-62.5
ground sphere turns the 1-ulp differences of XLA's CPU arithmetic (FMA
contraction, an approximate rsqrt) into a discrete choice (ROADMAP.md
queue C). The rays are held exactly to the independent NumPy oracle of
the JAX package (tpu_ray/oracle/cpu_oracle.py) on the scene and camera the
JAX script rendered, and to JAX's within the bounces of the branching
paths.
"""
import importlib.util
import os
import re

import numpy as np
import pytest

from tpu_ray.models import path_tracer as jpath_tracer
from tpu_ray.oracle.cpu_oracle import CpuOracle

from tests.test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(ROOT, "tpu_ray_torch", "examples")
JAX_EXAMPLES = os.path.join(ROOT, "examples")
W, H = 64, 40
TINY = ["--width", str(W), "--height", str(H), "--spp", "1"]
CPU = TINY + ["--device", "cpu"]
MAX_BOUNCES = 5          # both examples' render_pass


def _load(directory, name):
    path = os.path.join(directory, name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(PORT_EXAMPLES, name)


def test_progressive_render(tmp_path):
    out = str(tmp_path / "r.png")
    state = _port("01_progressive_render").main(
        CPU + ["--scene", "rgb", "--passes", "2", "--out", out])
    assert int(state.samples) == 2
    assert os.path.getsize(out) > 100


def test_custom_scene(tmp_path):
    out = str(tmp_path / "c.png")
    img = _port("02_custom_scene").main(CPU + ["--out", out]).numpy()
    assert np.isfinite(img).all() and img.max() > 0.0
    assert os.path.getsize(out) > 100


@pytest.mark.parametrize("scene", ["rtweekend", "rgb"])
def test_pixel_gradients(scene):
    d_scene, d_camera = _port("03_pixel_gradients").main(
        CPU + ["--scene", scene])
    if scene == "rtweekend":
        # sky on: radiance is continuous in ray direction, so geometry AND
        # camera gradients are nonzero (see the example docstring)
        for leaf in (d_scene.albedo, d_scene.center, d_camera.position):
            a = leaf.numpy()
            assert np.isfinite(a).all()
            assert np.abs(a).max() > 0.0
    else:
        # no sky: material grads flow, camera grads are the true a.e.
        # derivative of a piecewise-constant radiance = exactly zero
        assert np.abs(d_scene.emissive.numpy()).max() > 0.0
        assert np.abs(d_camera.position.numpy()).max() == 0.0


def test_inverse_rendering():
    _, err0, err = _port("04_inverse_rendering").main(
        CPU + ["--scene", "rgb", "--steps", "12", "--lr", "0.05"])
    assert err < err0, (err0, err)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_triangle_mesh(tmp_path, backend):
    out = str(tmp_path / "t.png")
    img = _port("06_triangle_mesh").main(
        CPU + ["--subdivisions", "1", "--backend", backend, "--out", out])
    img = img.numpy()
    assert np.isfinite(img).all() and img.max() > 0.0


@pytest.mark.parametrize("shading", ["flat", "lambert_shadow"])
def test_simple_estimators(tmp_path, shading):
    out = str(tmp_path / "e.png")
    rays = _port("07_simple_estimators").main(
        CPU + ["--scene", "sixteen", "--backend", "fused",
               "--shading", shading, "--out", out])
    n = W * H
    assert rays == n if shading == "flat" else rays > n
    assert os.path.getsize(out) > 100


def test_big_meshes(tmp_path):
    out = str(tmp_path / "b.png")
    # subdivisions=2 keeps the CPU run fast, as in tests/test_examples.py;
    # the card runs the default past the residency rule (chip_smoke.py)
    img, gs = _port("08_big_meshes").main(
        CPU + ["--subdivisions", "2", "--grad", "--out", out])
    assert np.isfinite(img.numpy()).all()
    assert float(gs.tris.v0.abs().sum()) > 0
    assert os.path.getsize(out) > 100


def _rays(capsys) -> int:
    """The count of the "N rays cast" line the example just printed."""
    m = re.search(r"([\d,]+) rays cast", capsys.readouterr().out)
    return int(m.group(1).replace(",", ""))


def _pixel_off(a, b):
    """Per pixel, the largest difference of its three values."""
    return np.abs(a - b).max(axis=-1)


@pytest.mark.parametrize("name,flags", [
    ("02_custom_scene", []),
    ("06_triangle_mesh", ["--subdivisions", "1"])])
def test_example_matches_jax(tmp_path, capsys, monkeypatch, name, flags):
    seen = {}
    inner = jpath_tracer.render_pass

    def spy(scene, camera, **kw):
        seen.update(scene=scene, camera=camera)
        return inner(scene, camera, **kw)

    # the JAX script imports render_pass when main() runs
    monkeypatch.setattr(jpath_tracer, "render_pass", spy)
    jflags = ["--backend", "jnp"] if name == "06_triangle_mesh" else []
    ref = np.asarray(_load(JAX_EXAMPLES, name).main(
        TINY + flags + jflags + ["--out", str(tmp_path / "j.png")]))
    ref_rays = _rays(capsys)
    got = _port(name).main(CPU + flags + [
        "--backend", "torch", "--out", str(tmp_path / "p.png")]).numpy()
    rays = _rays(capsys)

    cam = seen["camera"]
    _, orc_rays = CpuOracle(seen["scene"]).render_pass(
        np.asarray(cam.position), np.asarray(cam.look_at), W, H,
        spp=1, max_bounces=MAX_BOUNCES)

    assert rays == orc_rays
    assert np.isclose(got, ref, rtol=1e-5, atol=1e-6).mean() >= 0.97
    off = _pixel_off(got, ref) >= 2e-3
    assert off.mean() <= 1 / 512, off.sum()
    assert abs(rays - ref_rays) <= (MAX_BOUNCES - 1) * off.sum()
