"""Port parity, gradients of the per-sample fused route
(kernels/bounce_step.FusedSample: K4 forward, K5 replay, K6 backward, here
their plain versions) against the port's own eager and regen routes, and
the eager routes' remat; the training step and the CLI's fit on the route.
The same route against the JAX package's make_fused_sample is in
tests/test_torch_fused_grad.py; the two files are apart so that the
suite's workers (one file each) run them side by side.

The port's routes compute the same forward, so against each other each
leaf group holds 3e-3 of its largest |grad| on every lane.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_ray_torch.core.camera import (camera_to_numpy, default_camera,
                                       trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
from tpu_ray_torch.kernels.bounce_step import bounce_bwd, bounce_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB = 32, 16, 2, 5
GROUPS = ("center", "radius", "albedo", "emissive", "specular", "ior",
          "position", "look_at")


def _max_rel(got, want):
    return {k: np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            / max(np.abs(want[k]).max(), 1e-6) for k in GROUPS}


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
