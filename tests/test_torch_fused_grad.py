"""Port parity, gradients of the per-sample fused route
(kernels/bounce_step.FusedSample: K4 forward, K5 replay, K6 backward, here
their plain versions) against the JAX package's make_fused_sample run in
interpret mode, against the port's own eager and regen routes, and the
eager routes' remat; the training step and the CLI's fit on the route.

Bounds: each leaf group within 3e-3 of its largest |grad|, the bound
tests/test_regen_grad.py holds its routes to, on the lanes whose colour
the two forwards agree on within 1e-5 (as tests/test_torch_regen_grad.py
holds the regen route to JAX's); over all lanes within a measured 1e-2:
near-tie and grazing-hit differences between XLA's contracted f32 chains
and the port's separately rounded ones move a few lanes' paths
(ROADMAP.md queue C). The port's routes compute the same forward, so
against each other the bound holds on every lane.
"""
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import make_fused_sample as jmake_sample
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch.core.camera import (camera_from_numpy, camera_to_numpy,
                                       default_camera, trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
from tpu_ray_torch.kernels.bounce_step import (bounce_bwd, bounce_replay,
                                               make_fused_sample)
from tpu_ray_torch.models.path_tracer import tile_order

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB = 32, 16, 2, 5
GROUPS = ("center", "radius", "albedo", "emissive", "specular", "ior",
          "position", "look_at")


def _grad_dict(gs, gc):
    g = {k: np.asarray(getattr(gs, k)) for k in GROUPS[:6]}
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    return g


def _max_rel(got, want):
    return {k: np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            / max(np.abs(want[k]).max(), 1e-6) for k in GROUPS}


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


def _image_grads(name, backend, regen=False, **kw):
    base = make_scene(name, device="cpu")
    sc = trainable_scene(base)
    cam = trainable_camera(default_camera(base))
    img = render_mean(sc, cam, width=W, height=H, spp=SPP, backend=backend,
                      regen=regen, **kw)
    w = torch.as_tensor(np.random.RandomState(1).rand(H, W, 3).astype(
        np.float32))
    (img * w).sum().backward()
    g = scene_to_numpy(sc, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return img.detach(), g


@pytest.mark.parametrize("name", ["rtweekend", "rgb"])
def test_fused_grad_matches_port_routes(name):
    """The per-sample route against torch.autograd of the eager bounce
    loop and against the regen route (K2-record / K3 plain versions):
    the same image, and every group within 3e-3 of its max."""
    img, g = _image_grads(name, "fused")
    for backend, regen in (("torch", False), ("fused", True)):
        img_r, g_r = _image_grads(name, backend, regen)
        torch.testing.assert_close(img, img_r, rtol=1e-6, atol=1e-7)
        rel = _max_rel(g, g_r)
        assert max(rel.values()) < 3e-3, (backend, regen, rel)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_remat_grads_equal(backend):
    """render_mean(remat=True) recomputes each sample in the backward:
    the image and every gradient equal those without it."""
    img0, g0 = _image_grads("rtweekend", backend)
    img1, g1 = _image_grads("rtweekend", backend, remat=True)
    assert torch.equal(img0, img1)
    for key in GROUPS:
        np.testing.assert_array_equal(g0[key], g1[key])


def test_fused_backward_takes_plain_on_cpu():
    before = (bounce_replay.launches, bounce_bwd.launches)
    _image_grads("rgb", "fused")
    assert (bounce_replay.launches, bounce_bwd.launches) == before


def test_train_step_lowers_loss_fused_no_regen():
    """make_train_step on the per-sample route, with the JAX package's
    flags (cull_secondary, exact_argmin, remat ignored on fused) lowers the
    loss over 5 steps on rgb."""
    base = make_scene("rgb", device="cpu")
    cam = default_camera(base)
    kw = dict(width=W, height=H, spp=1, backend="fused", regen=False,
              cull_secondary=True, exact_argmin=True, remat=True,
              fixed_samples=True)
    with torch.no_grad():
        target = render_mean(base, cam, width=W, height=H, spp=1,
                             backend="fused")
    start = trainable_scene(base)
    with torch.no_grad():
        start.albedo.mul_(0.7)
    init_fn, step_fn = make_train_step(train_camera=False, **kw)
    state = init_fn(start, cam)
    losses = []
    for _ in range(5):
        state, loss = step_fn(state, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert float(image_mse(target, target)) == 0.0


def test_cli_fit_no_regen(tmp_path):
    out = tmp_path / "fit.png"
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run(
        [sys.executable, "-m", "tpu_ray_torch.cli", "fit", "--device", "cpu",
         "--scene", "rgb", "--width", "16", "--height", "16", "--spp", "1",
         "--steps", "2", "--backend", "fused", "--no-regen",
         "--cull-secondary", "--exact-argmin", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "final loss" in p.stderr
