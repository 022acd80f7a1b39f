"""Port parity, the regen route on triangle scenes and its permutation:
kernels/regen (the plain version of K2's triangle mode, the route, the
recording forward) against the JAX package's regen_step run in interpret
mode and its frozen goldens.

The route runs on the Morton-permuted scene, as the JAX package's does
(permute_scene at tpu_ray/kernels/regen.py:1197 and :1291): its winner
records are permuted ids and an exact tie in t goes to the lower permuted
id. Bounds: the K2 plain version against JAX regen_step(tri_lists=...)
as tests/test_torch_kernels.py holds the sphere step (ROADMAP.md queue
C: JAX's search roots come from bf16 splits and its f32 chains are
contracted into FMAs); the route against the regen goldens within the
golden suite's own rtol 1e-5 / atol 1e-6 (measured: trimesh 3.6e-7,
objico 6.0e-8), rays exact.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import SceneBuilder as JSceneBuilder
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import BLOCK_R as JBLOCK_R
from tpu_ray.kernels.bounce_step import _fused_tables
from tpu_ray.kernels.bounce_step import permute_scene as jpermute_scene
from tpu_ray.kernels.regen import (_list_mode, _step_lists, _wave_init,
                                   regen_step)
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import SceneBuilder, make_scene
from tpu_ray_torch.kernels.bounce_step import morton_perm
from tpu_ray_torch.kernels.regen import (regen_record, regen_steps,
                                         regen_steps_plain, regen_tables,
                                         wave_init)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order
from tpu_ray_torch.ops.intersect import nearest_hit

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
MB = 5


def _name(name):
    return f"obj:{OBJ}" if name == "objico" else name


def _jax_steps(js, jc, w, h, spp, steps):
    """JAX's regen route on the permuted scene for ``steps`` steps from one
    _wave_init state, as make_regen_trace's recording forward runs it
    (exact argmin, the resident-table list sweep for triangles) -> (first
    state [24, R_pad], last state, records [steps, R_pad], cam13, r)."""
    jp = jpermute_scene(js)
    tb = _fused_tables(jp)
    perm, _ = jtile_order(w, h)
    st0, cam, r = _wave_init(jc, jnp.asarray(perm), spp, 0, 0, w, h,
                             JBLOCK_R)
    use_list, grp = _list_mode(tb, st0.shape[1], JBLOCK_R)
    st, recs = st0, []
    for _ in range(steps):
        st, rec = regen_step(
            cam, tb["t48"], tb["stab_full"], st, tb["tri_full"],
            _step_lists(tb, st, JBLOCK_R, grp) if use_list else None,
            use_sky=jp.use_sky, max_bounces=MB, width=w, height=h,
            exact_argmin=True, with_idx=True, group=grp)
        recs.append(np.asarray(rec).reshape(-1))
    return (np.array(st0), np.array(st),
            np.stack(recs) if recs else None, np.array(cam)[0], r)


def test_k2_triangle_plain_matches_pallas():
    """regen_steps_plain with the triangle search table against JAX
    regen_step(tri_lists=...) (#4, _regen_list_kernel) in interpret mode:
    2 steps from one _wave_init state of objico at 32x24, 1 spp."""
    js = jmake_scene(_name("objico"))
    st0, out, recs, cam, r = _jax_steps(js, jdefault_camera(js), 32, 24, 1,
                                        2)
    table, tri, n_tri = regen_tables(make_scene(_name("objico"),
                                                device="cpu"))
    st = torch.as_tensor(st0)
    _, got = regen_steps_plain(st, torch.as_tensor(cam), table, 2, seg=1,
                               tri=tri, use_sky=True, max_bounces=MB,
                               width=32, height=24)
    a, b = st.numpy(), out
    rec_same = got.rec.numpy() == recs
    assert rec_same[:, :r].mean() >= 0.99
    hit_tri = recs[:, :r] >= table.shape[0] - n_tri
    assert hit_tri.mean() > 0.2, "the step hits the mesh"
    ctrl = (12, 14, 15, 22)
    for ch in ctrl:
        assert (a[ch] == b[ch]).mean() >= 0.99, ch
    agree = np.logical_and.reduce([a[ch] == b[ch] for ch in ctrl]
                                  + [rec_same.all(0)])
    smooth = [6, 7, 8, 9, 10, 11, 16, 17, 18, 19, 20, 23]
    np.testing.assert_allclose(a[smooth][:, agree], b[smooth][:, agree],
                               rtol=1e-5, atol=1e-5)
    close = np.isclose(a[0:6], b[0:6], rtol=1e-5, atol=1e-5).all(axis=0)
    assert close[agree].mean() >= 0.97, close[agree].mean()


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_regen_route_matches_golden(name):
    """fused + regen at 32x24, 1 spp against the JAX regen route's frozen
    render (exact argmin): rays exact, image within the golden suite's
    own bound."""
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-regen-exact.npz"))
    ts = make_scene(_name(name), device="cpu")
    img, rays = render_pass(ts, default_camera(ts), width=32, height=24,
                            spp=1, seed=0, backend="fused", regen=True)
    assert rays == int(z["rays"])
    np.testing.assert_allclose(img.numpy(), z["image"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_recording_forward_bit_identical_tri(name):
    """The recording forward advances the state exactly as the
    forward-only one on a triangle scene, and its records hold triangle
    ids (at or past the spheres')."""
    ts = make_scene(_name(name), device="cpu")
    table, tri, n_tri = regen_tables(ts)
    perm, _ = tile_order(32, 16)
    st, cam, _ = wave_init(default_camera(ts), torch.as_tensor(perm), 2, 0,
                           0, 32, 16)
    kw = dict(use_sky=True, max_bounces=MB, width=32, height=16)
    a, b = st.clone(), st.clone()
    before = (regen_steps.launches, regen_record.launches)
    regen_steps(a, cam, table, 2 * MB, tri=tri, **kw)
    recs = regen_record(b, cam, table, 2 * MB, 4, tri=tri, **kw)
    assert (regen_steps.launches, regen_record.launches) == before
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(recs.t_end.sum()) == int(a[22].sum())
    assert (recs.rec >= table.shape[0] - n_tri).any()
    assert int(recs.rec.max()) < table.shape[0]


def test_regen_records_follow_jax_permutation():
    """The winner records of the port's recording forward on rtweekend
    (32x16, 2 spp, all 10 steps) equal those of JAX's regen route (exact
    argmin), which are ids of the Morton-permuted scene, on every lane
    whose colour the two routes give within 1e-5. A route that searched
    the spheres in scene order would record other ids."""
    js = jmake_scene("rtweekend")
    st0, out, recs, cam, r = _jax_steps(js, jdefault_camera(js), 32, 16, 2,
                                        2 * MB)
    ts = make_scene("rtweekend", device="cpu")
    table, tri, _ = regen_tables(ts)
    st = torch.as_tensor(st0[:, :r].copy())
    got = regen_record(st, torch.as_tensor(cam), table, 2 * MB, 4, tri=tri,
                       use_sky=True, max_bounces=MB, width=32, height=16)
    agree = np.abs(st[16:19].numpy() - out[16:19, :r]).max(0) <= 1e-5
    assert agree.mean() >= 0.97, agree.mean()
    rec = got.rec.numpy()
    np.testing.assert_array_equal(rec[:, agree], recs[:, :r][:, agree])
    # the permutation moves most winners: scene-order ids would not match
    perm = morton_perm(ts).numpy()
    live = recs[:, :r][:, agree] >= 0
    moved = perm[recs[:, :r][:, agree][live]] != recs[:, :r][:, agree][live]
    assert moved.mean() > 0.5


def _tie_scenes():
    """Two spheres that the ray o = 0, d = +z meets at exactly t = 4 in the
    projection form (centre (0,0,5), r 1 and centre (0,0.75,5), r 1.25:
    dyadic values), with different materials. The second in scene order
    comes first in Morton order, so the tie goes to it."""
    def fill(b):
        b.add((0.0, 0.75, 5.0), 1.25, (0.9, 0.2, 0.1), emissive=(2, 0, 0),
              world_scale=False)
        b.add((0.0, 0.0, 5.0), 1.0, (0.1, 0.8, 0.3), emissive=(0, 3, 0),
              world_scale=False)
        return dict(look_at=(0.0, 0.0, 5.0), use_sky=True,
                    default_distance=6.0, default_x_angle=0.0,
                    default_y_height=0.0)
    jb, tb = JSceneBuilder(), SceneBuilder()
    js = jb.build(**fill(jb))
    ts = tb.build(device="cpu", **fill(tb))
    return js, ts


def test_exact_tie_follows_jax():
    """An exact tie in t: the port's regen step, like JAX's, takes the
    sphere that comes first in Morton order (scene index 1), records its
    permuted id 0 and adds its emission."""
    js, ts = _tie_scenes()
    o = torch.zeros(1, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]])
    for k in (0, 1):
        h = nearest_hit(ts.center[k:k + 1], ts.radius[k:k + 1], o, d)
        assert h.t.item() == 4.0
    assert morton_perm(ts)[:2].tolist() == [1, 0]
    st0, out, recs, cam, r = _jax_steps(js, jdefault_camera(js), 8, 8, 1, 0)
    st0[0:6, 0] = [0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    jp = jpermute_scene(js)
    tb = _fused_tables(jp)
    out, rec = regen_step(jnp.asarray(cam[None]), tb["t48"], tb["stab_full"],
                          jnp.asarray(st0), use_sky=True, max_bounces=MB,
                          width=8, height=8, exact_argmin=True,
                          with_idx=True)
    out, rec = np.asarray(out), np.asarray(rec).reshape(-1)
    table, tri, _ = regen_tables(ts)
    st = torch.as_tensor(st0.copy())
    _, got = regen_steps_plain(st, torch.as_tensor(cam), table, 1, seg=1,
                               tri=tri, use_sky=True, max_bounces=MB,
                               width=8, height=8)
    assert rec[0] == 0 and got.rec[0, 0].item() == 0
    np.testing.assert_allclose(st.numpy()[6:12, 0], out[6:12, 0], rtol=1e-6,
                               atol=1e-6)
    # the green sphere's emission (0, 3, 0) and albedo, not the red one's
    np.testing.assert_array_equal(st.numpy()[9:12, 0], [0.0, 3.0, 0.0])
