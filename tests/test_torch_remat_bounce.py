"""Port parity, remat="save_hits_bounce": ``grad.render_mean`` with each
bounce of the eager loop checkpointed on its own and replaying its own
stretch of the sample's ``HitTape`` (``models/path_tracer.trace_rays``),
against the JAX package's ``render_mean(..., remat="save_hits_bounce")``
and against the port's own remat=False; and, on a triangle scene, that
the per-bounce recompute replays the tape from each bounce's own mark and
never searches.

Sized as tests/test_grad.py:17-18 sizes its remat tests: rtweekend at
16x16, 1 spp. Bounds, with their reasons:

- Against JAX: each leaf group within 3e-3 of its largest |grad|, the
  bound of the port's eager-gradient tests against JAX
  (tests/test_torch_grad.py; XLA contracts FMAs and approximates rsqrt,
  ROADMAP.md queue C).
- Against the port's remat=False: tests/test_grad.py:140-146's bound,
  rtol 1e-4 and atol 1e-7 + 1e-5 of each leaf's max (measured: bit for
  bit).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.grad import image_mse as jimage_mse
from tpu_ray.grad import render_mean as jrender_mean

from tests.test_torch_threads import one_thread  # noqa: F401
from tpu_ray_torch.core.camera import (camera_to_numpy, default_camera,
                                       trainable_camera)
from tpu_ray_torch.core.scene import (SCENE_LEAVES, make_scene,
                                      make_trimesh_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.grad import image_mse, render_mean
from tpu_ray_torch.models import path_tracer as pt

W = H = 16
KW = dict(width=W, height=H, spp=1)
TRI_KW = dict(width=32, height=16, spp=1, max_bounces=3)


def _port_grads(scene, **kw):
    s, c = trainable_scene(scene), trainable_camera(default_camera(scene))
    img = render_mean(s, c, **{**KW, **kw})
    image_mse(img, torch.zeros_like(img)).backward()
    g = scene_to_numpy(s, grad=True)
    g.update(camera_to_numpy(c, grad=True))
    return g


@pytest.fixture(scope="module")
def rtw():
    """JAX's save_hits_bounce gradients, and the port's remat=False and
    save_hits_bounce ones on both eager backends, rtweekend 16x16 1 spp
    against a zero target."""
    js = jmake_scene("rtweekend")

    def loss(s, c):
        img = jrender_mean(s, c, **KW, remat="save_hits_bounce")
        return jimage_mse(img, jnp.zeros((H, W, 3), jnp.float32))

    gs, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(js, jdefault_camera(js))
    jg = {k: np.asarray(getattr(gs, k)) for k in SCENE_LEAVES}
    jg.update(position=np.asarray(gc.position),
              look_at=np.asarray(gc.look_at))
    ts = make_scene("rtweekend", device="cpu")
    port = {(b, r): _port_grads(ts, backend=b, remat=r)
            for b in ("torch", "cuda") for r in (False, "save_hits_bounce")}
    return jg, port


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_save_hits_bounce_grads_match_jax(rtw, backend):
    jg, port = rtw
    got = port[(backend, "save_hits_bounce")]
    nonzero = 0
    for k, b in jg.items():
        scale = max(np.abs(b).max(), 1e-6)
        err = np.abs(got[k].astype(np.float64) - b).max() / scale
        assert err < 3e-3, (k, err)
        nonzero += float(np.abs(b).sum()) > 0
    assert nonzero >= 4
    assert np.abs(got["center"]).max() > 0 and np.abs(got["position"]).max() > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_save_hits_bounce_grads_match_no_remat(rtw, backend):
    _, port = rtw
    ref, got = port[(backend, False)], port[(backend, "save_hits_bounce")]
    for k, b in ref.items():
        np.testing.assert_allclose(
            got[k], b, rtol=1e-4,
            atol=1e-7 + 1e-5 * max(1e-30, np.abs(b).max()), err_msg=k)


def test_per_bounce_replay_never_searches():
    """trimesh (subdivision 1) at 32x16 (tests/test_tri_stream.py's size),
    3 bounces, two searches a bounce (spheres, triangles): the forward
    records every search once; the backward replays them (the sample's
    recompute, then bounces from their own marks: a seek back) and
    searches nothing; the gradients are "save_hits"'s bit for bit."""
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    tapes, searching = [], [True]

    class Logged(pt.HitTape):
        def __init__(self):
            super().__init__()
            self.replayed = []
            tapes.append(self)

        def search(self, n_prim, fn, *args):
            if self.next is not None:
                self.replayed.append(self.next)
            return super().search(n_prim, fn, *args)

    def guarded(fn):
        def run(*a, **k):
            if not searching[0]:
                pytest.fail("searched in the backward")
            return fn(*a, **k)
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(pt, "HitTape", Logged)
    mp.setitem(pt._SEARCH, "torch", guarded(pt._SEARCH["torch"]))
    mp.setitem(pt._TRI_SEARCH, "torch", guarded(pt._TRI_SEARCH["torch"]))
    try:
        s, c = trainable_scene(ts), trainable_camera(default_camera(ts))
        img = render_mean(s, c, **TRI_KW, remat="save_hits_bounce")
        tape = tapes[0]
        assert len(tape.saved) == 2 * 3 and tape.replayed == []
        searching[0] = False
        image_mse(img, torch.zeros_like(img)).backward()
    finally:
        mp.undo()
    assert len(tapes) == 1
    rep = tape.replayed
    assert rep[:6] == list(range(6)), rep
    assert len(rep) > 6 and all(0 <= p < 6 for p in rep)
    assert any(b < a for a, b in zip(rep, rep[1:])), rep
    g = scene_to_numpy(s, grad=True)
    g.update(camera_to_numpy(c, grad=True))
    ref = _port_grads(ts, **TRI_KW, remat="save_hits")
    for k, v in ref.items():
        np.testing.assert_array_equal(g[k], v, err_msg=k)
    assert np.abs(ref["tris.v0"]).sum() > 0
