"""Port parity, the route past the residency rule, forward: the plain
version of K10 (``kernels/tri_intersect.tri_stream_plain``, which the
wrapper ``tri_nearest_hit_stream`` takes on CPU tensors) against the JAX
package's ``nearest_hit_tri_stream`` in interpret mode and against the
port's full sweep, and the route (``models/path_tracer``: the probe with
``alive``, the sorted-bounce wavefront, the fallback of "fused") against
JAX's ``render_pass`` through its stream route, the unsorted trace and the
frozen golden ``trimesh-stream-sorted``.

Sized as tests/test_tri_stream.py sizes them: ``make_trimesh_scene(
subdivisions=1|2)`` at 64x36 or 32x16, 1 spp, 3 bounces; the rule is
forced false (``force_stream``) on these resident scenes. Bounds, with
their reasons:

- Plain K10 against JAX's streaming kernel (bf16-split tables): winners
  equal on the alive lanes, t within rtol 1.4e-5, PR 8's measured bound of
  the full sweep against the bf16 Pallas sweep (measured here: 2.0e-6
  relative, 1.2e-6 absolute on primary rays; 8.4e-7 on scattered rays).
  JAX leaves dead lanes' results meaningless, so only alive lanes compare.
- Plain K10 against the port's full sweep: bit for bit on alive lanes
  (the lists' grazing acceptance fuzz, ``tri_block_lists``, does not occur
  here), and every dead lane a miss (t = F32_MAX, idx 0).
- The route: "fused" (with and without regen, falling back to the probe
  route) equal to backend "torch" bit for bit; both within the golden
  suite's rtol 1e-5 / atol 1e-6 of JAX's jnp render through its stream
  route, rays exact.
- Sorted against unsorted bounces: rays exact, radiance bit for bit
  (measured: no lane differs; each lane runs the same ops, and the port
  takes every sqrt in f64 and every reciprocal as a true division).

tests/test_torch_cuda.py holds K10 against this plain version on the card.
"""
import contextlib
import os
import re
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tpu_ray.models.path_tracer as jpt
from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.kernels import bounce_step as jbs
from tpu_ray.kernels.tri_intersect import nearest_hit_tri_stream
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import (make_obj_scene, make_scene,
                                      make_trilight_scene,
                                      make_trimesh_scene)
from tpu_ray_torch.core.trimesh import icosphere
from tpu_ray_torch.kernels import bounce_step, simple_shade
from tpu_ray_torch.kernels.bounce_step import BLOCK_R, tri_tile_boxes
from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit_stream,
                                                 tri_stream_plain)
from tpu_ray_torch.models import path_tracer as pt
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri, tri_search_table
from tpu_ray_torch.ops.shading_modes import scene_light_indices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
ROUTE = dict(width=32, height=16, spp=1, sample_start=0, max_bounces=3)
_MAX = 1e30


def _never(n, m):
    return False


@contextlib.contextmanager
def force_stream(sort_off: bool = False):
    """The residency rule forced false in both packages (JAX's
    ``bounce_step.resident_tables_fit`` and every name the port imported
    it under), optionally with the sort off in both; JAX's jit caches are
    cleared around it (its render_pass is a module-level jit whose cache
    key does not see the patch, tests/test_tri_stream.py:21-32)."""
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jbs, pt, simple_shade, bounce_step):
            mp.setattr(mod, "resident_tables_fit", _never)
        if sort_off:
            for mod in (jpt, pt):
                orig = mod.trace_rays
                mp.setattr(mod, "trace_rays", lambda *a, _f=orig, **k: _f(
                    *a, **{**k, "sort_rays": False}))
        jax.clear_caches()
        yield
    finally:
        jax.clear_caches()
        mp.undo()


def _scattered(r=2048, seed=11):
    """Incoherent rays (secondary-bounce-like), tests/test_tri_stream.py's."""
    g = np.random.default_rng(seed)
    o = g.uniform(-0.5, 0.5, (r, 3)).astype(np.float32)
    d = g.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _primary(w=64, h=36):
    js = jmake_trimesh(subdivisions=2)
    o, d, _ = jcamera_rays(jdefault_camera(js), w, h,
                           jnp.arange(w * h, dtype=jnp.int32),
                           jnp.uint32(0), 0)
    return np.array(o), np.array(d)


def _alive(r):
    """A mask with its second 256-lane block wholly dead and every fifth
    lane dead."""
    a = np.ones(r, bool)
    a[BLOCK_R:2 * BLOCK_R] = False
    a[::5] = False
    return a


@pytest.fixture(scope="module")
def small():
    """(JAX scene, port scene, its search table, its tile boxes):
    trimesh at subdivisions=2, 642 triangles in 6 tiles."""
    js = jmake_trimesh(subdivisions=2)
    ts = make_trimesh_scene(subdivisions=2, device="cpu")
    return js, ts, tri_search_table(ts.tris), tri_tile_boxes(ts.tris)


@pytest.mark.parametrize("rays", ["primary", "scattered"])
def test_plain_matches_jax_stream(small, rays):
    js, _, tab, boxes = small
    o, d = _primary() if rays == "primary" else _scattered()
    al = _alive(o.shape[0])
    ref = nearest_hit_tri_stream(js.tris, jnp.asarray(o), jnp.asarray(d),
                                 alive=jnp.asarray(al))
    got = tri_stream_plain(tab, boxes, torch.as_tensor(o),
                           torch.as_tensor(d), torch.as_tensor(al))
    jt, ji = np.asarray(ref.t)[al], np.asarray(ref.idx)[al]
    gt, gi = got.t.numpy()[al], got.idx.numpy()[al]
    hit = gt < 1e29
    assert hit.sum() > 100, "too few hits for the parity to mean much"
    np.testing.assert_array_equal(jt < 1e29, hit)
    np.testing.assert_array_equal(ji, gi)
    np.testing.assert_allclose(gt[hit], jt[hit], rtol=1.4e-5, atol=0)


@pytest.mark.parametrize("case", ["primary", "scattered", "dead_block"])
def test_plain_matches_full_sweep(small, case):
    """Bit for bit against nearest_hit_tri on the alive lanes; dead lanes
    (a whole dead block, every fifth lane) miss. On CPU tensors the K10
    wrapper is the plain version and launches nothing."""
    _, _, tab, boxes = small
    o, d = _primary() if case == "primary" else _scattered()
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    al = (torch.as_tensor(_alive(o.shape[0])) if case == "dead_block"
          else None)
    ref = nearest_hit_tri(tab, o, d)
    tri_nearest_hit_stream.launches = 0
    got = tri_nearest_hit_stream(tab, boxes, o, d, al)
    assert tri_nearest_hit_stream.launches == 0
    live = torch.ones(o.shape[0], dtype=torch.bool) if al is None else al
    assert torch.equal(got.t[live], ref.t[live])
    assert torch.equal(got.idx[live], ref.idx[live])
    assert bool((got.t[~live] == _MAX).all())
    assert bool((got.idx[~live] == 0).all())
    assert int((got.t[live] < _MAX).sum()) > 100
    # a lane slice keeps its full-launch block's list
    lanes = torch.arange(3, o.shape[0], 32)
    part = tri_stream_plain(tab, boxes, o, d, al, lanes=lanes)
    assert torch.equal(part.t, got.t[lanes])
    assert torch.equal(part.idx, got.idx[lanes])


@pytest.fixture(scope="module")
def tiny():
    """trimesh at subdivisions=1 on the CPU, and its render of ROUTE with
    the rule forced and the sort off: backend torch's, and JAX's jnp one
    through its stream route."""
    js = jmake_trimesh(subdivisions=1)
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    with force_stream(sort_off=True):
        img, rays = jpt.render_pass(js, jdefault_camera(js), backend="jnp",
                                    **ROUTE)
        ref = pt.render_pass(ts, default_camera(ts), backend="torch",
                             **ROUTE)
    return ts, np.asarray(img), int(rays), ref


ROUTES = {"torch": dict(backend="torch"),
          "fused_regen": dict(backend="fused", regen=True),
          "fused": dict(backend="fused", regen=False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_stream_route_matches_jax(tiny, route):
    ts, jimg, jrays, (ref, ref_rays) = tiny
    with force_stream(sort_off=True):
        img, rays = pt.render_pass(ts, default_camera(ts), **ROUTES[route],
                                   **ROUTE)
    assert rays == ref_rays == jrays
    assert torch.equal(img, ref)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("route", ["torch", "fused_regen"])
def test_sorted_bounces_match_unsorted(tiny, route):
    """The sorted wavefront (on by default past the rule) gives the
    unsorted trace's rays and radiance bit for bit; each probe of a later
    bounce sees its alive lanes first, in ascending direction octant."""
    ts = tiny[0]
    cam = default_camera(ts)
    seen = []
    orig = pt.probe_for

    def spying(scene, backend):
        pf = orig(scene, backend)

        def run(sc, o, d, alive=None, tape=None):
            seen.append((d.clone(), alive.clone()))
            return pf(sc, o, d, alive, tape)
        return run

    with force_stream():
        mp = pytest.MonkeyPatch()
        mp.setattr(pt, "probe_for", spying)
        try:
            a, ra = pt.render_pass(ts, cam, **ROUTES[route], **ROUTE)
        finally:
            mp.undo()
    b, rb = tiny[3]
    assert ra == rb
    assert torch.equal(a, b)
    assert len(seen) == ROUTE["max_bounces"]
    for d, alive in seen[1:]:
        n_live = int(alive.sum())
        assert 0 < n_live < alive.shape[0]
        assert bool(alive[:n_live].all())
        oct_ = ((d[:n_live] > 0).long() * torch.tensor([4, 2, 1])).sum(1)
        assert bool((oct_[1:] >= oct_[:-1]).all())


def test_golden_stream_sorted():
    """tests/test_golden.py's stream-sorted case: trimesh 32x24, 1 spp,
    the default bounces, backend torch with the rule forced (sorted)."""
    z = np.load(os.path.join(GOLDEN_DIR, "trimesh-stream-sorted.npz"))
    ts = make_scene("trimesh", device="cpu")
    with force_stream():
        img, rays = pt.render_pass(ts, default_camera(ts), width=32,
                                   height=24, spp=1, sample_start=0, seed=0)
    assert rays == int(z["rays"])
    np.testing.assert_allclose(img.numpy(), z["image"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shading", ["flat", "lambert_shadow"])
def test_fused_estimators_fall_back(shading):
    """Past the rule the fused estimators warn (the message says
    "streaming") and give backend torch's image and rays (the eager
    estimator on the streaming search)."""
    ts = (make_trilight_scene(device="cpu") if shading == "lambert_shadow"
          else make_trimesh_scene(subdivisions=1, device="cpu"))
    lights = scene_light_indices(ts) if shading == "lambert_shadow" else ()
    kw = dict(ROUTE, shading=shading, lights=lights)
    cam = default_camera(ts)
    with force_stream():
        ref, ref_rays = pt.render_pass(ts, cam, backend="torch", **kw)
        with pytest.warns(UserWarning, match="streaming"):
            img, rays = pt.render_pass(ts, cam, backend="fused", **kw)
    assert rays == ref_rays
    assert torch.equal(img, ref)
    assert ref.mean().item() > 0.01


def test_obj_past_the_rule_warns(tmp_path):
    """An icosphere(5) OBJ (20,480 faces) is past the rule and warns about
    the streaming route (tests/test_tri_stream.py:204-218)."""
    v, f = icosphere(5)
    p = tmp_path / "big.obj"
    with open(p, "w") as fh:
        for x, y, z in v:
            fh.write(f"v {x} {y} {z}\n")
        for a, b, c in f + 1:
            fh.write(f"f {a} {b} {c}\n")
    with pytest.warns(UserWarning, match="streaming"):
        scene = make_obj_scene(str(p), device="cpu")
    assert scene.tris.n_pad > 20000
    assert pt.past_residency(scene)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        make_trimesh_scene(subdivisions=1, device="cpu")


def test_cli_renders_bigmesh(tmp_path, capsys):
    """``render --scene bigmesh`` runs (it was refused): fused falls back
    to the streaming route; each of the 64 pixels casts 1 to 5 rays
    (tests/test_torch_core.py::test_unported_scenes_refuse holds the
    count across backends)."""
    out = tmp_path / "b.png"
    assert cli.main(["render", "--scene", "bigmesh", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--backend", "fused", "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    rays = int(re.search(r"(\d+) rays", capsys.readouterr().err).group(1))
    assert 64 < rays <= 5 * 64


def test_every_probe_feeds_the_stream_search(tiny):
    """Past the rule every probe of a pass searches the triangles through
    tri_nearest_hit_stream with the wavefront's alive mask; within it,
    never."""
    ts = tiny[0]
    calls = []
    orig = pt.tri_nearest_hit_stream

    def counting(tab, boxes, o, d, alive=None):
        calls.append(None if alive is None else int(alive.sum()))
        return orig(tab, boxes, o, d, alive)

    mp = pytest.MonkeyPatch()
    mp.setattr(pt, "tri_nearest_hit_stream", counting)
    try:
        pt.render_pass(ts, default_camera(ts), backend="torch", **ROUTE)
        assert calls == []
        with force_stream():
            _, rays = pt.render_pass(ts, default_camera(ts),
                                     backend="torch", **ROUTE)
    finally:
        mp.undo()
    assert len(calls) == ROUTE["max_bounces"]
    assert calls[0] == ROUTE["width"] * ROUTE["height"]
    assert sum(calls) == rays
