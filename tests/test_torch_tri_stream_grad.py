"""Port parity, the route past the residency rule, gradients:
``grad.render_mean(..., remat="save_hits")`` through the streaming search
(``models/path_tracer``: the fallback of "fused", the sorted-bounce
wavefront, ``HitTape``) against the port's resident route and the JAX
package's ``render_mean`` through its stream route, the three remat modes
against each other, bigmesh itself, and the CLI's fit past the rule.

Sized as tests/test_tri_stream.py:147-195 sizes them: trimesh at
subdivisions=1, 32x16, 1 spp, 3 bounces, the rule forced false. Bounds,
with their reasons:

- The stream route against the port's resident route: the tolerances of
  tests/test_tri_stream.py, rtol 1e-5 / atol 1e-6 of each leaf's max with
  the sort off (measured: bit for bit), rtol 1e-4 / atol 1e-5 of each
  leaf's max with it on (the sums over rays into a leaf run in another
  lane order; measured 6.7e-8 of a leaf's max); at least 4 nonzero
  leaves.
- Against JAX's stream route: 1e-4 of each leaf's max. The packages
  differ there exactly as they do on the resident route, where XLA
  contracts FMAs and approximates rsqrt (ROADMAP.md queue C): measured on
  the triangle vertices 5.5e-5 of a leaf's max on both routes (2.4e-6
  elsewhere), past the 1e-5 that tests/test_tri_stream.py holds JAX's
  two routes to; the stream route adds nothing in either package (the
  test above, and tests/test_tri_stream.py for JAX).
- remat "save_hits", "save_hits_bounce", True and False: bit for bit,
  and the backward of "save_hits" and "save_hits_bounce" calls no search
  (a counter around each).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.grad import image_mse as jimage_mse
from tpu_ray.grad import render_mean as jrender_mean

from tests.test_torch_tri_stream import force_stream
from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import default_camera, trainable_camera
from tpu_ray_torch.core.scene import (SCENE_LEAVES, make_scene,
                                      make_trimesh_scene, trainable_scene)
from tpu_ray_torch.core.trimesh import TRI_LEAVES, icosphere
from tpu_ray_torch.grad import image_mse, render_mean
from tpu_ray_torch.models import path_tracer as pt
from tpu_ray_torch.ops.intersect import Hit

W, H = 32, 16
KW = dict(width=W, height=H, spp=1, max_bounces=3)
STREAM = dict(backend="fused", regen=True, remat="save_hits")
TOL = {"sort_off": (1e-5, 1e-6), "sort_on": (1e-4, 1e-5)}


def _jax_grads(js, **kw):
    target = jnp.zeros((H, W, 3), jnp.float32)

    def loss(s, c):
        return jimage_mse(jrender_mean(s, c, **KW, **kw), target)

    gs, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(js, jdefault_camera(js))
    g = {k: np.asarray(getattr(gs, k)) for k in SCENE_LEAVES}
    g.update({f"tris.{k}": np.asarray(getattr(gs.tris, k))
              for k in TRI_LEAVES})
    g.update(position=np.asarray(gc.position),
             look_at=np.asarray(gc.look_at))
    return g


def _port_grads(ts, width=W, height=H, **kw):
    s, c = trainable_scene(ts), trainable_camera(default_camera(ts))
    img = render_mean(s, c, **{**KW, "width": width, "height": height, **kw})
    image_mse(img, torch.zeros_like(img)).backward()
    g = {k: s.leaf(k).grad.numpy() for k in s.leaves}
    g.update(position=c.position.grad.numpy(), look_at=c.look_at.grad.numpy())
    return g


@pytest.fixture(scope="module")
def grads():
    """The port's gradients on the resident route, and each package's on
    the stream route with the sort off and on (remat="save_hits")."""
    js = jmake_trimesh(subdivisions=1)
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    out = {"resident": (None, _port_grads(ts, backend="torch",
                                          remat="save_hits"))}
    for sort in TOL:
        with force_stream(sort_off=sort == "sort_off"):
            out[sort] = (_jax_grads(js, backend="jnp", remat="save_hits"),
                         _port_grads(ts, **STREAM))
    return out


def _assert_close(got, ref, rtol, atol_scale):
    nonzero = 0
    for k, b in ref.items():
        np.testing.assert_allclose(
            got[k], b, rtol=rtol,
            atol=atol_scale * max(1e-30, np.abs(b).max()), err_msg=k)
        nonzero += float(np.abs(b).sum()) > 0
    assert nonzero >= 4, "grad parity is vacuous: too many zero leaves"


@pytest.mark.parametrize("sort", list(TOL))
def test_stream_grads_match_resident_route(grads, sort):
    _assert_close(grads[sort][1], grads["resident"][1], *TOL[sort])


@pytest.mark.parametrize("sort", list(TOL))
def test_stream_grads_match_jax(grads, sort):
    jst, pst = grads[sort]
    nonzero = 0
    for k, b in jst.items():
        scale = max(1e-30, np.abs(b).max())
        err = np.abs(pst[k] - b).max()
        assert err <= 1e-4 * scale, (k, err / scale)
        nonzero += float(np.abs(b).sum()) > 0
    assert nonzero >= 4


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_save_hits_runs_no_search_in_the_backward(backend):
    """remat "save_hits", "save_hits_bounce", True and False give the same
    gradients bit for bit; only "save_hits" and "save_hits_bounce" have a
    backward that searches nothing (True re-runs every search)."""
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    calls = [0]
    sph_key = "torch" if backend == "torch" else "cuda"

    def counted(fn):
        def run(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return run

    kw = dict(backend=backend, regen=backend == "fused")
    with force_stream():
        mp = pytest.MonkeyPatch()
        mp.setitem(pt._SEARCH, sph_key, counted(pt._SEARCH[sph_key]))
        mp.setattr(pt, "tri_nearest_hit_stream",
                   counted(pt.tri_nearest_hit_stream))
        try:
            got = {}
            for remat in (False, True, "save_hits", "save_hits_bounce"):
                s = trainable_scene(ts)
                c = trainable_camera(default_camera(ts))
                calls[0] = 0
                img = render_mean(s, c, remat=remat, **KW, **kw)
                fwd = calls[0]
                calls[0] = 0
                image_mse(img, torch.zeros_like(img)).backward()
                got[remat] = ({k: s.leaf(k).grad for k in s.leaves},
                              c.position.grad, fwd, calls[0])
        finally:
            mp.undo()
    ref, ref_pos, fwd0, bwd0 = got[False]
    assert fwd0 == 2 * KW["max_bounces"] and bwd0 == 0
    assert got[True][3] == fwd0 and got["save_hits"][3] == 0
    assert got["save_hits_bounce"][3] == 0
    for remat in (True, "save_hits", "save_hits_bounce"):
        g, pos, fwd, _ = got[remat]
        assert fwd == fwd0
        assert torch.equal(pos, ref_pos)
        for k in ref:
            assert torch.equal(g[k], ref[k]), (remat, k)


def test_hit_tape_records_and_replays():
    """The tape keeps the hit mask and the winner (i16 below 2^15
    primitives, i32 past it) and replays them in call order, or from a
    position a bounce marked; and remat="save_hits_bounce", which replays
    it a bounce at a time, gives "save_hits"'s gradients bit for bit on
    the eager route."""
    hits = [Hit(t=torch.tensor([1.5, 1e30, 0.25]),
                idx=torch.tensor([3, 0, 40000], dtype=torch.int32)),
            Hit(t=torch.tensor([1e30, 2.0, 3.0]),
                idx=torch.tensor([0, 7, 9], dtype=torch.int32))]
    tape = pt.HitTape()
    tape.rewind()
    for h, n in zip(hits, (2 ** 16, 128)):
        assert tape.search(n, lambda h=h: h) is h
    assert [i.dtype for _, i in tape.saved] == [torch.int32, torch.int16]
    tape.rewind()
    for h, n in zip(hits, (2 ** 16, 128)):
        got = tape.search(n, lambda: pytest.fail("searched on replay"))
        assert torch.equal(got.t < 1e29, h.t < 1e29)
        assert torch.equal(got.idx, h.idx)
    assert tape.mark() == 2
    tape.seek(1)
    got = tape.search(128, lambda: pytest.fail("searched on replay"))
    assert torch.equal(got.idx, hits[1].idx) and tape.mark() == 2
    fresh = pt.HitTape()
    fresh.seek(fresh.mark())
    assert fresh.search(128, lambda: hits[0]) is hits[0]
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    g = {remat: _port_grads(ts, backend="torch", remat=remat)
         for remat in ("save_hits", "save_hits_bounce")}
    for k, v in g["save_hits"].items():
        np.testing.assert_array_equal(g["save_hits_bounce"][k], v,
                                      err_msg=k)


def test_bigmesh_save_hits_grads():
    """bigmesh itself (163,968 padded triangles, past the rule unforced),
    8x8, 1 spp, 5 bounces: "save_hits" gives remat=False's gradients bit
    for bit on the fused route, which falls back to the streaming search;
    its backward searches nothing; the triangle winners are kept as i32."""
    big = make_scene("bigmesh", device="cpu")
    ref = _port_grads(big, width=8, height=8, max_bounces=5,
                      backend="fused", regen=True)
    tapes = []
    orig = pt.HitTape

    class Watched(orig):
        def __init__(self):
            super().__init__()
            tapes.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(pt, "HitTape", Watched)
    try:
        got = _port_grads(big, width=8, height=8, max_bounces=5,
                          backend="fused", regen=True, remat="save_hits")
    finally:
        mp.undo()
    assert len(tapes) == 1 and tapes[0].next == len(tapes[0].saved)
    assert {i.dtype for _, i in tapes[0].saved} == {torch.int16,
                                                    torch.int32}
    nonzero = 0
    for k, v in ref.items():
        assert np.isfinite(v).all(), k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        nonzero += float(np.abs(v).sum()) > 0
    assert nonzero >= 4
    assert np.abs(ref["tris.v0"]).sum() > 0


def test_cli_fits_past_the_rule(tmp_path):
    """``fit`` on a mesh past the rule runs (such scenes were refused):
    one step at 8x8 on an icosphere(5) OBJ (20,480 faces; bigmesh takes
    the same route at 8x the triangles), which warns as it loads."""
    v, f = icosphere(5)
    obj = tmp_path / "big.obj"
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in v)
                   + "".join(f"f {a} {b} {c}\n" for a, b, c in f + 1))
    out = tmp_path / "fit.png"
    with pytest.warns(UserWarning, match="streaming"):
        assert cli.main(["fit", "--scene", f"obj:{obj}", "--device", "cpu",
                         "--width", "8", "--height", "8", "--spp", "1",
                         "--steps", "1", "--backend", "fused",
                         "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
