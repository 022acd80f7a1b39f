"""Port parity, gradients on triangle scenes: the regen route's
RegenTrace (K2's recording forward, K3's backward with its triangle
branch) against the JAX package's make_regen_trace, against the port's
eager route, and regen_bwd_plain against autograd of its own forward;
the CLI on triangle scenes.

Bounds. Against JAX, 3e-3 of each leaf group's largest |grad| on the
lanes whose colour the two forwards give within 1e-5 (the bound
tests/test_regen_grad.py holds JAX's own regen routes to), and a measured
1e-5 over all lanes: on objico every lane's colour agrees and the
gradients agree within 1.3e-7 of each group's max (rtweekend needs 1e-2
there, tests/test_torch_regen_grad.py, for its near-tie flips). The regen
route
(plane-form triangle hit, hand transpose) against the eager route
(Möller-Trumbore payload, autograd): 3e-3. The hand transpose against
autograd of the same forward: 3e-5.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.regen import make_regen_trace as jmake_regen_trace
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import (camera_from_numpy, camera_to_numpy,
                                       default_camera, trainable_camera)
from tpu_ray_torch.core.scene import (make_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.core.trimesh import TRI_LEAVES
from tpu_ray_torch.grad import image_mse, render_mean
from tpu_ray_torch.kernels.regen import (make_regen_trace, regen_bwd_plain,
                                         regen_record, regen_tables,
                                         step_tail_plain, wave_init)
from tpu_ray_torch.models.path_tracer import tile_order

OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
W, H, SPP, MB = 32, 16, 2, 5
SPHERE = ("center", "radius", "albedo", "emissive", "specular", "ior")
GROUPS = SPHERE + tuple(f"tris.{k}" for k in TRI_LEAVES) + ("position",
                                                             "look_at")


def _grad_dict(gs, gc):
    g = {k: np.asarray(getattr(gs, k)) for k in SPHERE}
    g.update({f"tris.{k}": np.asarray(getattr(gs.tris, k))
              for k in TRI_LEAVES})
    g.update(position=np.asarray(gc.position), look_at=np.asarray(gc.look_at))
    return g


@pytest.fixture(scope="module")
def jax_grads():
    """JAX make_regen_trace (exact argmin, seg=4) on objico at 32x16,
    2 spp: jax.grad of sum(color * w) for numpy weights w, and for w cut
    to the lanes whose colour the port's forward gives within 1e-5."""
    px = jnp.asarray(jtile_order(W, H)[0])
    js = jmake_scene(f"obj:{OBJ}")
    jc = jdefault_camera(js)
    cam = {"position": np.asarray(jc.position),
           "look_at": np.asarray(jc.look_at)}
    tr = jmake_regen_trace(W, H, 0, MB, SPP, exact_argmin=True, seg=4)
    grad = jax.jit(jax.grad(
        lambda s, c, w: jnp.sum(tr(s, c, px, 0)[0] * w), argnums=(0, 1)))
    wts = np.random.RandomState(0).rand(W * H, 3).astype(np.float32)
    color = np.asarray(tr(js, jc, px, 0)[0])
    port, _ = make_regen_trace(W, H, 0, MB, SPP)(
        make_scene(f"obj:{OBJ}", device="cpu"),
        camera_from_numpy(cam, device="cpu"), torch.as_tensor(np.array(px)),
        0)
    agree = np.abs(port.numpy() - color).max(axis=1) <= 1e-5
    cut = wts * agree[:, None]
    return dict(wts=wts, cut=cut, cam=cam, agree=agree,
                grads=_grad_dict(*grad(js, jc, jnp.asarray(wts))),
                grads_cut=_grad_dict(*grad(js, jc, jnp.asarray(cut))))


def _port_grads(wts, cam_np, backend="fused"):
    ts = trainable_scene(make_scene(f"obj:{OBJ}", device="cpu"))
    cam = camera_from_numpy(cam_np, device="cpu", requires_grad=True)
    px = torch.as_tensor(tile_order(W, H)[0])
    if backend == "fused":
        color, _ = make_regen_trace(W, H, 0, MB, SPP, seg=4)(ts, cam, px, 0)
    else:
        from tpu_ray_torch.models.path_tracer import render_pixels
        color, _ = render_pixels(ts, cam, px, width=W, height=H, spp=SPP,
                                 sample_start=0, max_bounces=MB,
                                 backend=backend)
    (color * torch.as_tensor(wts)).sum().backward()
    g = scene_to_numpy(ts, grad=True)
    g.update(camera_to_numpy(cam, grad=True))
    return g


def _max_rel(got, want):
    return {k: np.abs(np.asarray(got[k], np.float64) - want[k]).max()
            / max(np.abs(want[k]).max(), 1e-6) for k in GROUPS}


def test_regen_tri_grads_match_jax(jax_grads):
    """Every leaf, the triangles' included: 3e-3 of each group's max on
    the lanes whose colour agrees, 1e-5 over all lanes."""
    ref = jax_grads
    assert ref["agree"].mean() >= 0.97, ref["agree"].mean()
    rel = _max_rel(_port_grads(ref["wts"], ref["cam"]), ref["grads"])
    assert max(rel.values()) < 1e-5, rel
    got = _port_grads(ref["cut"], ref["cam"])
    rel = _max_rel(got, ref["grads_cut"])
    assert max(rel.values()) < 3e-3, rel
    for key in ("tris.e1", "tris.e2", "tris.albedo", "position"):
        assert np.abs(ref["grads"][key]).max() > 0.0, key
        assert np.abs(got[key]).max() > 0.0, key
    # objico has no spheres, and a flat triangle's normal does not depend
    # on where it is hit: moving v0 with e1, e2 fixed turns no direction,
    # so d/d v0 is exactly zero on both sides (on trimesh the glass sphere
    # makes it nonzero, test_train_step_reaches_triangle_leaves)
    assert not ref["grads"]["tris.v0"].any() and not got["tris.v0"].any()


def test_regen_tri_grads_match_eager_route(jax_grads):
    """The regen route (plane-form hit, K3's hand transpose) against
    autograd of the eager route (Möller-Trumbore payload): 3e-3 of each
    group's max."""
    ref = jax_grads
    a = _port_grads(ref["wts"], ref["cam"], "fused")
    b = _port_grads(ref["wts"], ref["cam"], "torch")
    rel = _max_rel(a, b)
    assert max(rel.values()) < 3e-3, rel


def test_regen_bwd_plain_matches_autograd_at_trimesh_p():
    """regen_bwd_plain on trimesh's 10,496-row table (its triangle branch)
    against autograd of the forward it reverses (step_tail_plain replayed
    from the records): d_state, d_table and d_cam within 3e-5 of each
    group's max."""
    ts = make_scene("trimesh", device="cpu")
    table, tri, n_tri = regen_tables(ts)
    assert table.shape[0] == 10496
    w, h, spp = 16, 12, 2
    perm, _ = tile_order(w, h)
    st0, cam, _ = wave_init(default_camera(ts), torch.as_tensor(perm), spp,
                            0, 0, w, h)
    kw = dict(use_sky=True, max_bounces=MB, width=w, height=h)
    steps = spp * MB
    recs = regen_record(st0.clone(), cam, table, steps, 4, tri=tri, **kw)
    assert (recs.rec >= table.shape[0] - n_tri).any()
    g = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (3, st0.shape[1])).astype(np.float32))
    d_out = torch.zeros_like(st0)
    d_out[16:19] = g
    d_st, d_tab, d_cam = regen_bwd_plain(recs, d_out, cam, table,
                                         n_tri=n_tri, **kw)

    st_v = st0.clone().requires_grad_()
    cam_v = cam.clone().requires_grad_()
    tab_v = table.detach().clone().requires_grad_()
    st = st_v
    for t in range(steps):
        idx = torch.where(t < recs.t_end.long(), recs.rec[t].long(), -1)
        st, _ = step_tail_plain(st, cam_v, tab_v, idx, n_tri=n_tri, **kw)
    want_st, want_cam, want_tab = torch.autograd.grad(
        (st[16:19] * g).sum(), (st_v, cam_v, tab_v))
    for got, want in ((d_st[0:6], want_st[0:6]), (d_st[6:9], want_st[6:9]),
                      (d_cam, want_cam[0:12])):
        torch.testing.assert_close(got, want, rtol=3e-5,
                                   atol=3e-5 * float(want.abs().max()))
    for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                 slice(10, 11), slice(11, 12)):
        want = want_tab[:, cols]
        torch.testing.assert_close(d_tab[:, cols], want, rtol=3e-5,
                                   atol=3e-5 * float(want.abs().max()))
    assert want_tab[ts.n_pad:, 0:4].abs().max() > 0


def test_train_step_reaches_triangle_leaves():
    """render_mean on trimesh through fused + regen: image_mse(...)
    .backward() fills every leaf's gradient, the triangles' included."""
    base = make_scene("trimesh", device="cpu")
    sc = trainable_scene(base)
    cam = trainable_camera(default_camera(base))
    img = render_mean(sc, cam, width=16, height=12, spp=1, backend="fused",
                      regen=True)
    image_mse(img, torch.zeros_like(img)).backward()
    for k in sc.leaves:
        assert sc.leaf(k).grad is not None, k
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo"):
        assert sc.leaf(k).grad.abs().max() > 0, k


def test_cli_render_and_scenes_trimesh(tmp_path, capsys):
    out = tmp_path / "t.png"
    assert cli.main(["render", "--scene", "trimesh", "--device", "cpu",
                     "--width", "16", "--height", "16", "--spp", "1",
                     "--backend", "fused", "--out", str(out)]) == 0
    assert out.stat().st_size > 0
    assert cli.main(["render", "--scene", f"obj:{OBJ}", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--out", str(out)]) == 0
    assert cli.main(["scenes"]) == 0
    text = capsys.readouterr().out
    assert "6: trimesh" in text and "10242 tris" in text
    assert "163842 tris" in text


def test_cli_fit_trimesh(tmp_path):
    """fit on trimesh: the triangle albedo joins the albedo group, the
    triangle geometry stays frozen (the JAX fit's _group)."""
    out = tmp_path / "fit.png"
    assert cli.main(["fit", "--scene", "trimesh", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--steps", "2", "--backend", "fused",
                     "--out", str(out)]) == 0
    assert out.stat().st_size > 0
