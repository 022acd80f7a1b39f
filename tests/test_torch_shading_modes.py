"""Port parity, the eager flat and Lambert+shadow estimators
(tpu_ray_torch/ops/shading_modes.py and their routing in
models/path_tracer.py) against the JAX package's (tpu_ray/ops/
shading_modes.py with ``probe_jnp``, and ``render_pass(backend="jnp")``).

Inputs: the JAX camera's rays of a 32x24 image (sample 0) handed to both
packages as numpy arrays, on single (flat), sixteen (Lambert, 2 lights),
trilight (Lambert, 1 light, 82 triangles; the JAX suite's
``_tri_light_scene``), trimesh (flat) and trimesh with Lambert, which has
no light (the port renders it: emissive plus sky).

Bounds, with their reasons: rays exact everywhere. Colours within the
golden suite's rtol 1e-5 / atol 1e-6 on at least 0.99 of the values and
within rtol 5e-5 / atol 2e-5 on all (flat differs only in the sky's last
bit, 2.4e-7): XLA contracts FMAs and approximates rsqrt where the port
rounds each f32 op (ROADMAP.md queue C), and on sixteen's small spheres
(radius 0.05 in world units) a hit point's rounding is a large share of
the normal, so n . l carries ~2e-6 of relative error into a light term
of emissive 12. Measured on sixteen: 15 of 2304 values of the 1-spp
rays past the golden bound, at most 2.3e-5 relative; in the 2-spp render
5 values past rtol 5e-5, at most 1.3e-5 absolute (JAX's own jnp and
fused routes differ on 3 values of the 1-spp golden render).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_shading_modes import _tri_light_scene
from tpu_ray import default_camera as jdefault_camera
from tpu_ray import make_scene as jmake_scene
from tpu_ray.models.path_tracer import probe_jnp
from tpu_ray.models.path_tracer import render_pass as jrender_pass
from tpu_ray.ops import shading_modes as JS
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch import PathTracer, RenderConfig, cli
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, make_trilight_scene
from tpu_ray_torch.models.path_tracer import probe_for, render_pass
from tpu_ray_torch.ops.shading_modes import (scene_light_data,
                                             scene_light_indices, trace_flat,
                                             trace_lambert_shadow)

W, H = 32, 24
# (scene, estimator) cases
CASES = [("single", "flat"), ("sixteen", "lambert_shadow"),
         ("trilight", "lambert_shadow"), ("trimesh", "flat"),
         ("trimesh", "lambert_shadow")]
NAMED = ["rgb", "randomized", "rtweekend", "single", "sixteen", "sixtyfour",
         "trimesh"]


def _assert_colors(got, want):
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=2e-5)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name in ("single", "sixteen", "trimesh", "trilight"):
        if name == "trilight":
            js, ts = _tri_light_scene(), make_trilight_scene(device="cpu")
        else:
            js, ts = jmake_scene(name), make_scene(name, device="cpu")
        out[name] = (js, jdefault_camera(js), ts, default_camera(ts))
    return out


@pytest.mark.parametrize("name,mode", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_estimators_match_jax_probe(scenes, name, mode):
    js, jcam, ts, _ = scenes[name]
    o, d, _ = jcamera_rays(jcam, W, H, jnp.arange(W * H, dtype=jnp.int32),
                           0, 0)
    o, d = np.asarray(o), np.asarray(d)
    lights = JS.scene_light_indices(js) if mode == "lambert_shadow" else ()
    to, td = torch.tensor(o), torch.tensor(d)
    probe = probe_for(ts, "torch")
    if mode == "flat":
        jc, jr = JS.trace_flat(js, o, d, probe_jnp)
        tc, tr = trace_flat(ts, to, td, probe)
    else:
        jc, jr = JS.trace_lambert_shadow(js, o, d, probe_jnp, lights)
        tc, tr = trace_lambert_shadow(ts, to, td, probe, lights)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    _assert_colors(tc.numpy(), np.asarray(jc))
    if lights:
        # some rays are lit and some are in shadow
        assert int(tr.sum()) > W * H and float(tc.max()) > 0


@pytest.fixture(scope="module")
def jax_renders(scenes):
    """JAX render_pass(backend="jnp") of every case: 32x24, 2 spp from
    sample 1."""
    out = {}
    for name, mode in CASES:
        js, jcam, _, _ = scenes[name]
        lights = JS.scene_light_indices(js) if mode != "flat" else ()
        img, rays = jrender_pass(js, jcam, width=W, height=H, spp=2,
                                 sample_start=1, shading=mode, lights=lights)
        out[name, mode] = (np.asarray(img), int(rays))
    return out


@pytest.mark.parametrize("name,mode", CASES,
                         ids=[f"{n}-{m}" for n, m in CASES])
def test_render_pass_matches_jax_jnp(scenes, jax_renders, name, mode):
    _, _, ts, tcam = scenes[name]
    lights = scene_light_indices(ts) if mode != "flat" else ()
    img, rays = render_pass(ts, tcam, width=W, height=H, spp=2,
                            sample_start=1, backend="torch", shading=mode,
                            lights=lights)
    want, want_rays = jax_renders[name, mode]
    assert rays == want_rays
    _assert_colors(img.numpy(), want)


@pytest.mark.parametrize("name,mode", CASES[:3],
                         ids=[f"{n}-{m}" for n, m in CASES[:3]])
def test_backends_and_chunks_agree(scenes, name, mode):
    """backend "cuda" takes the plain searches on CPU tensors, and ray
    slabs change nothing: all three renders are equal bit for bit."""
    _, _, ts, tcam = scenes[name]
    kw = dict(width=W, height=H, spp=1, sample_start=1, shading=mode,
              lights=scene_light_indices(ts) if mode != "flat" else ())
    a, ra = render_pass(ts, tcam, backend="torch", **kw)
    b, rb = render_pass(ts, tcam, backend="cuda", **kw)
    c, rc = render_pass(ts, tcam, backend="torch", ray_chunk=W * H // 4, **kw)
    assert ra == rb == rc
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("name", NAMED + ["trilight"])
def test_scene_light_indices_match_jax(name):
    if name == "trilight":
        js, ts = _tri_light_scene(), make_trilight_scene(device="cpu")
    else:
        js, ts = jmake_scene(name), make_scene(name, device="cpu")
    lights = scene_light_indices(ts)
    assert lights == JS.scene_light_indices(js)
    want = {"sixteen": (1, 2), "trilight": (0,), "single": (),
            "trimesh": ()}
    if name in want:
        assert lights == want[name]
    centers, emissives = scene_light_data(ts, lights)
    assert torch.equal(centers, ts.center[list(lights)])
    assert torch.equal(emissives, ts.emissive[list(lights)])
    assert bool((emissives != 0).any(dim=1).all())


@pytest.mark.parametrize("shading,lights", [("path", ()), ("flat", ()),
                                            ("lambert_shadow", (1, 2))])
def test_path_tracer_lights(shading, lights):
    cfg = RenderConfig(scene="sixteen", width=8, height=8, spp=1,
                       shading=shading)
    tracer = PathTracer(cfg, device="cpu")
    assert tracer.lights == lights
    state, rays = tracer.render(passes=1)
    assert state.samples == 1 and rays >= 64
    with pytest.raises(ValueError):
        RenderConfig(shading="phong")


@pytest.mark.parametrize("shading", ["flat", "lambert_shadow"])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_cli_render_estimators(tmp_path, capsys, shading, backend):
    """``render --shading`` writes the PNG; flat casts one ray a pixel,
    Lambert one more a light on each hit (sixteen has two lights)."""
    out = tmp_path / "e.png"
    assert cli.main(["render", "--scene", "sixteen", "--device", "cpu",
                     "--width", "16", "--height", "12", "--spp", "1",
                     "--backend", backend, "--shading", shading,
                     "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    err = capsys.readouterr().err
    rays = int(err.split(" rays")[0].split()[-1])
    if shading == "flat":
        assert rays == 16 * 12
    else:
        assert 16 * 12 < rays <= 3 * 16 * 12
