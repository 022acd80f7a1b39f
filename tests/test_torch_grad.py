"""Port parity, differentiable slice: grad.render_mean on the eager routes
against the JAX package's jax.grad of tpu_ray.grad.render_mean (backend
jnp) and against the port's own fused+regen gradients; the search cut out
of the graph; finite differences on smooth pixels; the training step; the
CLI's fit.

Bounds: each leaf group within 3e-3 of its largest |grad|, the bound
tests/test_regen_grad.py holds its routes to (measured: 9.7e-4 against
JAX's jnp route, on camera position; 1.6e-5 between the port's eager and
fused routes; 0 between the plain search and K1's wrapper).
"""
import dataclasses
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
from tpu_ray.grad import render_mean as jrender_mean

from tpu_ray_torch.core.camera import (camera_from_numpy, camera_to_numpy,
                                       default_camera, trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, scene_from_numpy,
                                      scene_to_numpy, trainable_scene)
from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
from tpu_ray_torch.kernels.sphere_intersect import sphere_nearest_hit
from tpu_ray_torch.ops.intersect import nearest_hit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GW, GH, GSPP = 16, 16, 2
GROUPS = ("center", "radius", "albedo", "emissive", "specular", "ior",
          "position", "look_at")


def _leaf_grads(scene, cam):
    g = scene_to_numpy(scene, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return g


def _max_rel(got, want):
    return {k: np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            / max(np.abs(want[k]).max(), 1e-6) for k in GROUPS}


def _port_image_grads(backend, wts, cam_np, name="rtweekend", **kw):
    ts = trainable_scene(make_scene(name, device="cpu"))
    cam = camera_from_numpy(cam_np, device="cpu", requires_grad=True)
    img = render_mean(ts, cam, width=GW, height=GH, spp=GSPP,
                      backend=backend, regen=backend == "fused", **kw)
    (img * torch.as_tensor(wts)).sum().backward()
    return img.detach().numpy(), _leaf_grads(ts, cam)


@pytest.fixture(scope="module")
def jnp_grads():
    """jax.grad of sum(render_mean(backend='jnp') * w) at rtweekend 16x16,
    2 spp, for numpy weights w, and the port's eager gradients of the
    same loss."""
    js = jmake_scene("rtweekend")
    jc = jdefault_camera(js)
    cam = {"position": np.asarray(jc.position),
           "look_at": np.asarray(jc.look_at)}
    wts = np.random.RandomState(3).rand(GH, GW, 3).astype(np.float32)

    def loss(s, c):
        return jnp.sum(jrender_mean(s, c, width=GW, height=GH, spp=GSPP,
                                    backend="jnp") * jnp.asarray(wts))

    gs, gc = jax.jit(jax.grad(loss, argnums=(0, 1)))(js, jc)
    g = {k: np.asarray(getattr(gs, k)) for k in GROUPS[:6]}
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    _, port = _port_image_grads("torch", wts, cam)
    return dict(cam=cam, wts=wts, grads=g, port=port)


def test_torch_route_grad_matches_jax(jnp_grads):
    rel = _max_rel(jnp_grads["port"], jnp_grads["grads"])
    assert max(rel.values()) < 3e-3, rel
    for key in ("center", "albedo", "position"):
        assert np.abs(jnp_grads["port"][key]).max() > 0.0, key


@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_port_routes_agree(jnp_grads, backend):
    """The eager route with K1's wrapper, and the fused+regen route with
    its hand backward, against the eager plain route: the forwards agree
    lane for lane, so within 3e-3 of each group's max."""
    img, got = _port_image_grads(backend, jnp_grads["wts"], jnp_grads["cam"])
    rel = _max_rel(got, jnp_grads["port"])
    assert max(rel.values()) < 3e-3, (backend, rel)


def test_search_carries_no_history():
    ts = trainable_scene(make_scene("rtweekend", device="cpu"))
    g = np.random.default_rng(0)
    o = torch.tensor(g.uniform(-0.5, 0.5, (64, 3)).astype(np.float32),
                     requires_grad=True)
    d = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(64, 3)).astype(np.float32)), dim=1)
    for search in (nearest_hit, sphere_nearest_hit):
        hit = search(ts.center, ts.radius, o, d)
        assert not hit.t.requires_grad and not hit.idx.requires_grad


def test_eager_graph_holds_no_search_tensor():
    """Nothing of shape [R, N] is saved for the backward of the eager
    route: only the O(R) payload recompute is in the graph."""
    ts = trainable_scene(make_scene("rtweekend", device="cpu"))
    cam = trainable_camera(default_camera(ts))
    r, n = GW * GH, ts.n_pad
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        img = render_mean(ts, cam, width=GW, height=GH, spp=1)
    assert shapes and img.requires_grad
    big = [s for s in shapes if int(np.prod(s)) >= r * n]
    assert not big, big
    image_mse(img, torch.zeros_like(img)).backward()
    assert ts.center.grad is not None and cam.position.grad is not None


def _regen_image(scene, cam):
    return render_mean(scene, cam, width=32, height=16, spp=2,
                       backend="fused", regen=True)


@pytest.mark.parametrize("param", ["center", "cam_pos"])
def test_regen_geometry_fd_masked(param):
    """Boundary-moving parameters against central differences through the
    port's fused forward, on the pixels whose radiance moves O(eps) inside
    the stencil (tests/test_regen_grad.py::test_regen_geometry_fd_masked's
    discipline and bound): raw differences also pick up the silhouette
    terms that the pathwise gradient leaves out."""
    base = make_scene("rtweekend", device="cpu")
    cam0 = default_camera(base)
    eps = 1e-3

    def with_param(v, grad=False):
        arrays = scene_to_numpy(base)
        cam_np = camera_to_numpy(cam0)
        if param == "center":
            arrays["center"][1, 1] = v
        else:
            cam_np["position"][0] = v
        arrays["look_at"] = base.look_at.numpy()
        sc = scene_from_numpy(arrays, device="cpu", requires_grad=grad,
                              use_sky=base.use_sky, n_real=base.n_real)
        return sc, camera_from_numpy(cam_np, device="cpu",
                                     requires_grad=grad)

    v0 = float(base.center[1, 1] if param == "center" else cam0.position[0])
    with torch.no_grad():
        ip = _regen_image(*with_param(v0 + eps)).double().numpy()
        im = _regen_image(*with_param(v0 - eps)).double().numpy()
    mask = np.abs(ip - im).max(axis=-1) < 10.0 * eps
    assert mask.mean() > 0.6, mask.mean()

    def masked_mse(img):
        return float(np.sum(mask[..., None] * img ** 2) / (3 * mask.sum()))

    fd = (masked_mse(ip) - masked_mse(im)) / (2 * eps)
    sc, cam = with_param(v0, grad=True)
    m = torch.as_tensor(mask, dtype=torch.float32)[..., None]
    img = _regen_image(sc, cam)
    (torch.sum(m * img ** 2) / (3 * m.sum())).backward()
    ad = float(sc.center.grad[1, 1] if param == "center"
               else cam.position.grad[0])
    assert abs(fd - ad) < 3e-3 + 0.6 * abs(fd), (param, fd, ad)


def test_train_step_regen():
    """make_train_step(fused, regen) lowers the loss over 5 steps on rgb
    with the albedo scaled by 0.7 (tests/test_regen_grad.py's case)."""
    scene = make_scene("rgb", device="cpu")
    cam = default_camera(scene)
    kw = dict(width=32, height=16, spp=2, backend="fused", regen=True)
    with torch.no_grad():
        target = render_mean(scene, cam, **kw)
    bad = dataclasses.replace(scene, albedo=torch.clamp(scene.albedo * 0.7,
                                                        0.0, 1.0))
    init_fn, step_fn = make_train_step(fixed_samples=True,
                                       train_camera=False, **kw)
    state = init_fn(bad, cam)
    assert not state.camera.position.requires_grad
    state, loss0 = step_fn(state, target)
    for _ in range(4):
        state, loss = step_fn(state, target)
    assert state.step == 5 and np.isfinite(float(loss))
    assert float(loss) < float(loss0), (float(loss0), float(loss))


def test_train_step_sample_start_advances():
    """Without fixed_samples each step renders the next spp samples: the
    first step's loss equals the loss of samples [0, spp), the second's
    that of [spp, 2 spp)."""
    scene = make_scene("rtweekend", device="cpu")
    cam = default_camera(scene)
    kw = dict(width=8, height=8, spp=1)
    target = torch.zeros((8, 8, 3))
    init_fn, step_fn = make_train_step(
        optimizer=lambda p: torch.optim.SGD(list(p.values()), lr=0.0), **kw)
    state = init_fn(scene, cam)
    losses = []
    for _ in range(2):
        state, loss = step_fn(state, target)
        losses.append(float(loss))
    with torch.no_grad():
        want = [float(image_mse(render_mean(scene, cam, sample_start=s,
                                            **kw), target)) for s in (0, 1)]
    assert losses == pytest.approx(want, rel=1e-6)
    assert losses[0] != losses[1]


def test_leaf_round_trip():
    scene = make_scene("rgb", device="cpu")
    arrays = scene_to_numpy(scene)
    arrays["look_at"] = scene.look_at.numpy()
    again = scene_from_numpy(arrays, device="cpu", requires_grad=True)
    assert again.center.requires_grad and not again.look_at.requires_grad
    for k, v in scene_to_numpy(again).items():
        np.testing.assert_array_equal(v, arrays[k])
    zeros = scene_to_numpy(again, grad=True)
    assert all(not v.any() for v in zeros.values())


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "tpu_ray_torch.cli", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_cli_fit_writes_png(tmp_path, backend):
    out = tmp_path / "fit.png"
    metrics = tmp_path / "fit.jsonl"
    p = _cli("fit", "--device", "cpu", "--scene", "rtweekend", "--width",
             "16", "--height", "16", "--spp", "1", "--steps", "3",
             "--backend", backend, "--out", str(out), "--metrics",
             str(metrics))
    assert p.returncode == 0, p.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 16
    assert "final loss" in p.stderr and "d_albedo" in p.stderr
    assert len(metrics.read_text().splitlines()) == 3 + 2


def test_cli_fit_refuses_mesh(tmp_path):
    p = _cli("fit", "--device", "cpu", "--width", "8", "--height", "8",
             "--steps", "1", "--mesh", "8", "--out", str(tmp_path / "f.png"))
    assert p.returncode != 0 and "not ported yet" in p.stderr
    assert not (tmp_path / "f.png").exists()
