"""Port parity, gradients of the per-sample fused route on triangle scenes
(kernels/bounce_step.FusedSample: K8 forward, K5 replay and K6 backward in
their triangle modes, here their plain versions) against the JAX
package's make_fused_sample run in interpret mode, against the port's
eager and regen routes, and the plain K6's triangle mode against autograd
of its forward; the training step and the CLI's fit on the route.

Scene: small trimesh (``make_trimesh_scene(subdivisions=2)``: a glass
sphere and 642 triangles), 32x24, 2 spp. objico is not used: its v0
gradient is exactly zero in both packages (no sphere, and a flat
triangle's normal does not depend on where it is hit), while here the
glass sphere makes it nonzero. Bounds, those of
tests/test_torch_tri_grad.py for the regen route: against JAX 3e-3 of each
leaf group's largest |grad| on the lanes whose colour the two forwards
give within 1e-5, and 1e-5 over all lanes (every lane's colour agrees
here; measured 2.5e-6); against the port's eager route (Möller-Trumbore
payload, autograd) 3e-3 (measured 8.4e-6); against the port's regen route
(the same plane form and hand transpose; measured 1.9e-7) and the plain
K6 against autograd of its forward, 3e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.kernels.bounce_step import make_fused_sample as jmake_sample
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import (camera_from_numpy, camera_to_numpy,
                                       default_camera, trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, make_trimesh_scene,
                                      scene_to_numpy, trainable_scene)
from tpu_ray_torch.core.trimesh import TRI_LEAVES
from tpu_ray_torch.grad import image_mse, make_train_step, render_mean
from tpu_ray_torch.kernels.bounce_step import (
    bounce_bwd, bounce_bwd_plain, bounce_fwd_list_plain, bounce_replay,
    bounce_replay_plain, fused_tables, init_state, make_fused_sample,
    origin_bound)
from tpu_ray_torch.models.path_tracer import render_pixels, tile_order
from tpu_ray_torch.ops.raygen import camera_rays

W, H, SPP, MB = 32, 24, 2, 5
SPHERE = ("center", "radius", "albedo", "emissive", "specular", "ior")
GROUPS = SPHERE + tuple(f"tris.{k}" for k in TRI_LEAVES) + ("position",
                                                             "look_at")


def _small():
    return make_trimesh_scene(subdivisions=2, device="cpu")


def _grad_dict(gs, gc):
    g = {k: np.asarray(getattr(gs, k)) for k in SPHERE}
    g.update({f"tris.{k}": np.asarray(getattr(gs.tris, k))
              for k in TRI_LEAVES})
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    return g


def _max_rel(got, want):
    return {k: np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            / max(np.abs(want[k]).max(), 1e-6) for k in GROUPS}


def _port_grads(wts, cam_np, backend="sample"):
    """Gradients of sum(color_sum * wts) over the 2 samples, through the
    per-sample route (FusedSample), the regen route or the eager route."""
    ts = trainable_scene(_small())
    cam = camera_from_numpy(cam_np, device="cpu", requires_grad=True)
    px = torch.as_tensor(tile_order(W, H)[0])
    if backend == "sample":
        sample = make_fused_sample(W, H, 0, MB)
        color = sum(sample(ts, cam, px, s)[0] for s in range(SPP))
    else:
        color, _ = render_pixels(ts, cam, px, width=W, height=H, spp=SPP,
                                 sample_start=0, max_bounces=MB,
                                 backend=backend, regen=backend == "fused")
    (color * torch.as_tensor(wts)).sum().backward()
    g = scene_to_numpy(ts, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return g


@pytest.fixture(scope="module")
def jax_grads():
    """JAX make_fused_sample (exact argmin; the list kernel on every
    bounce) on small trimesh: the cotangent of sum_s color_s pulled back
    for numpy weights w, and for w cut to the lanes whose colour the
    port's forward gives within 1e-5 (one forward; a second backward only
    where the cut weights differ)."""
    px = jnp.asarray(jtile_order(W, H)[0])
    js = jmake_trimesh(subdivisions=2)
    jc = jdefault_camera(js)
    cam = {"position": np.asarray(jc.position),
           "look_at": np.asarray(jc.look_at)}
    fs = jmake_sample(W, H, 0, MB, exact_argmin=True)
    color, pull = jax.vjp(
        lambda s, c: sum(fs(s, c, px, jnp.uint32(k))[0] for k in range(SPP)),
        js, jc)
    sample = make_fused_sample(W, H, 0, MB)
    port = sum(sample(_small(), camera_from_numpy(cam, device="cpu"),
                      torch.as_tensor(np.array(px)), s)[0]
               for s in range(SPP))
    agree = np.abs(port.numpy() - np.asarray(color)).max(axis=1) <= 1e-5
    wts = np.random.RandomState(0).rand(W * H, 3).astype(np.float32)
    cut = wts * agree[:, None]
    grads = _grad_dict(*pull(jnp.asarray(wts)))
    grads_cut = (grads if agree.all() else
                 _grad_dict(*pull(jnp.asarray(cut))))
    return dict(wts=wts, cut=cut, cam=cam, agree=agree, grads=grads,
                grads_cut=grads_cut)


def test_tri_fused_grads_match_jax(jax_grads):
    """Every leaf, the triangles' included: 3e-3 of each group's max on
    the lanes whose colour agrees, 1e-5 over all lanes; the v0 gradient
    nonzero in both packages."""
    ref = jax_grads
    assert ref["agree"].mean() >= 0.97, ref["agree"].mean()
    rel = _max_rel(_port_grads(ref["wts"], ref["cam"]), ref["grads"])
    assert max(rel.values()) < 1e-5, rel
    got = _port_grads(ref["cut"], ref["cam"])
    rel = _max_rel(got, ref["grads_cut"])
    assert max(rel.values()) < 3e-3, rel
    for key in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo", "center",
                "position"):
        assert np.abs(ref["grads"][key]).max() > 0.0, key
        assert np.abs(got[key]).max() > 0.0, key


def test_tri_fused_grads_match_port_routes(jax_grads):
    """The per-sample route against the port's regen route (the same
    plane form and hand transpose: 3e-5) and against autograd of the
    eager route (the Möller-Trumbore payload: 3e-3)."""
    ref = jax_grads
    a = _port_grads(ref["wts"], ref["cam"])
    for backend, tol in (("fused", 3e-5), ("torch", 3e-3)):
        rel = _max_rel(a, _port_grads(ref["wts"], ref["cam"], backend))
        assert max(rel.values()) < tol, (backend, rel)


@pytest.mark.parametrize("bounces", [0, 2])
def test_k6_tri_plain_matches_autograd(bounces):
    """bounce_bwd_plain with n_sph on trimesh's 10,496-row table is the
    transpose of bounce_replay_plain that autograd gives: d_state rows
    0-11 and d_table within 3e-5 of each group's max, triangle rows
    reached."""
    ts = make_scene("trimesh", device="cpu")
    tb = fused_tables(ts, origin_bound(default_camera(ts).position[None]))
    kw = dict(n_sph=tb.n_sph, use_sky=True)
    px = torch.as_tensor(tile_order(32, 16)[0])
    st = init_state(*camera_rays(default_camera(ts), 32, 16, px, 0, 0))
    for b in range(bounces):
        st, _ = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, b, **kw)
    _, idx = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, bounces,
                                   **kw)
    assert (idx >= tb.n_sph).any()
    g = torch.as_tensor(np.random.default_rng(bounces).standard_normal(
        st.shape).astype(np.float32))
    g[12:16] = 0.0
    st_v = st.clone().requires_grad_()
    tb_v = tb.table.detach().clone().requires_grad_()
    out = bounce_replay_plain(st_v, tb_v, idx, bounces, **kw)
    d_st_ref, d_tab_ref = torch.autograd.grad(out, (st_v, tb_v), g)
    d_st, d_tab = bounce_bwd_plain(st, tb.table, idx, bounces, g.clone(),
                                   **kw)
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)):
        want = d_st_ref[rows]
        torch.testing.assert_close(d_st[rows], want, rtol=3e-5,
                                   atol=3e-5 * float(want.abs().max()))
    for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                 slice(10, 11), slice(11, 12)):
        want = d_tab_ref[:, cols]
        torch.testing.assert_close(d_tab[:, cols], want, rtol=3e-5,
                                   atol=3e-5 * float(want.abs().max()))
    assert d_tab_ref[tb.n_sph:, 0:4].abs().max() > 0


def test_tri_fused_backward_takes_plain_on_cpu():
    """render_mean through the per-sample route on trimesh fills every
    leaf's gradient, the triangles' included, on the plain versions."""
    base = make_scene("trimesh", device="cpu")
    sc = trainable_scene(base)
    cam = trainable_camera(default_camera(base))
    before = (bounce_replay.launches, bounce_bwd.launches)
    img = render_mean(sc, cam, width=16, height=12, spp=1, backend="fused",
                      regen=False)
    image_mse(img, torch.zeros_like(img)).backward()
    assert (bounce_replay.launches, bounce_bwd.launches) == before
    for k in sc.leaves:
        assert sc.leaf(k).grad is not None, k
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo"):
        assert sc.leaf(k).grad.abs().max() > 0, k


def test_train_step_lowers_loss_tri_no_regen():
    """make_train_step on the per-sample route on small trimesh, the
    optimizer given the triangles' albedo alone, lowers the loss over 4
    steps."""
    base = _small()
    cam = default_camera(base)
    kw = dict(width=16, height=12, spp=1, backend="fused", regen=False,
              fixed_samples=True)
    with torch.no_grad():
        target = render_mean(base, cam, width=16, height=12, spp=1,
                             backend="fused", regen=False)
    start = trainable_scene(base)
    with torch.no_grad():
        start.tris.albedo.mul_(0.6)
    init_fn, step_fn = make_train_step(
        train_camera=False, optimizer=lambda params: torch.optim.Adam(
            [params["tris.albedo"]], lr=1e-2), **kw)
    state = init_fn(start, cam)
    losses = []
    for _ in range(4):
        state, loss = step_fn(state, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_cli_fit_no_regen_trimesh(tmp_path):
    out = tmp_path / "fit.png"
    assert cli.main(["fit", "--scene", "trimesh", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--steps", "2", "--backend", "fused", "--no-regen",
                     "--exact-argmin", "--out", str(out)]) == 0
    assert out.stat().st_size > 0
