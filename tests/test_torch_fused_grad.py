"""Port parity, gradients of the per-sample fused route
(kernels/bounce_step.FusedSample: K4 forward, K5 replay, K6 backward, here
their plain versions) against the JAX package's make_fused_sample run in
interpret mode. The route against the port's own eager and regen routes,
the eager routes' remat, the training step and the CLI's fit on the route
are in tests/test_torch_fused_grad_routes.py.

Bounds: each leaf group within 3e-3 of its largest |grad|, the bound
tests/test_regen_grad.py holds its routes to, on the lanes whose colour
the two forwards agree on within 1e-5 (as tests/test_torch_regen_grad.py
holds the regen route to JAX's); over all lanes within a measured 1e-2:
near-tie and grazing-hit differences between XLA's contracted f32 chains
and the port's separately rounded ones move a few lanes' paths
(ROADMAP.md queue C).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import make_fused_sample as jmake_sample
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch.core.camera import camera_from_numpy, camera_to_numpy
from tpu_ray_torch.core.scene import (make_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.kernels.bounce_step import make_fused_sample
from tpu_ray_torch.models.path_tracer import tile_order

from tests.test_torch_fused_grad_routes import GROUPS, H, MB, SPP, W, _max_rel


def _grad_dict(gs, gc):
    g = {k: np.asarray(getattr(gs, k)) for k in GROUPS[:6]}
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    return g


def _port_colors(name, cam_np):
    ts = make_scene(name, device="cpu")
    px = torch.as_tensor(tile_order(W, H)[0])
    sample = make_fused_sample(W, H, 0, MB)
    cam = camera_from_numpy(cam_np, device="cpu")
    return sum(sample(ts, cam, px, s)[0] for s in range(SPP)).numpy()


def _port_grads(name, wts, cam_np, **kw):
    """Gradients of sum_s sum(color_s * wts) through the port's per-sample
    route (FusedSample)."""
    ts = trainable_scene(make_scene(name, device="cpu"))
    cam = camera_from_numpy(cam_np, device="cpu", requires_grad=True)
    px = torch.as_tensor(tile_order(W, H)[0])
    sample = make_fused_sample(W, H, 0, MB, **kw)
    tot = sum((sample(ts, cam, px, s)[0] * torch.as_tensor(wts)).sum()
              for s in range(SPP))
    tot.backward()
    g = scene_to_numpy(ts, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return g


@pytest.fixture(scope="module")
def jax_grads():
    """JAX make_fused_sample (exact argmin) on rtweekend and rgb at 32x16,
    2 samples: jax.grad of sum_s sum(color_s * w) for numpy weights w, and
    for w cut to the lanes whose colour sum the port's forward gives within
    1e-5."""
    out = {}
    px = jnp.asarray(jtile_order(W, H)[0])
    for name in ("rtweekend", "rgb"):
        js = jmake_scene(name)
        jc = jdefault_camera(js)
        cam = {"position": np.asarray(jc.position),
               "look_at": np.asarray(jc.look_at)}
        fs = jmake_sample(W, H, 0, MB, exact_argmin=True)

        def loss(s, c, w):
            return sum(jnp.sum(fs(s, c, px, jnp.uint32(k))[0] * w)
                       for k in range(SPP))

        grad = jax.jit(jax.grad(loss, argnums=(0, 1)))
        color = sum(np.asarray(fs(js, jc, px, jnp.uint32(k))[0])
                    for k in range(SPP))
        agree = np.abs(_port_colors(name, cam) - color).max(axis=1) <= 1e-5
        wts = np.random.RandomState(0).rand(W * H, 3).astype(np.float32)
        cut = wts * agree[:, None]
        out[name] = dict(
            wts=wts, cut=cut, cam=cam, agree=agree,
            grads=_grad_dict(*grad(js, jc, jnp.asarray(wts))),
            grads_cut=_grad_dict(*grad(js, jc, jnp.asarray(cut))))
    return out


@pytest.mark.parametrize("name", ["rtweekend", "rgb"])
def test_fused_grad_matches_jax(jax_grads, name):
    ref = jax_grads[name]
    assert ref["agree"].mean() >= 0.97, ref["agree"].mean()
    rel = _max_rel(_port_grads(name, ref["wts"], ref["cam"]), ref["grads"])
    assert max(rel.values()) < 1e-2, (name, rel)
    got = _port_grads(name, ref["cut"], ref["cam"])
    rel = _max_rel(got, ref["grads_cut"])
    assert max(rel.values()) < 3e-3, (name, rel)
    nonzero = ("albedo",) + (("center", "position") if name == "rtweekend"
                             else ())
    for key in nonzero:
        assert np.abs(ref["grads"][key]).max() > 0.0, (name, key)
        assert np.abs(got[key]).max() > 0.0, (name, key)


@pytest.mark.parametrize("name", ["rtweekend", "rgb"])
def test_cull_secondary_grads_bit_identical(jax_grads, name):
    ref = jax_grads[name]
    a = _port_grads(name, ref["wts"], ref["cam"])
    b = _port_grads(name, ref["wts"], ref["cam"], cull_secondary=True)
    for key in GROUPS:
        np.testing.assert_array_equal(a[key], b[key])


