"""Port parity, the listed triangle mode of the regen route: kernels/regen
regen_steps_plain with the tile boxes (the plain version of K2's listed
mode) against the JAX package's regen_step(tri_lists=_step_lists(...))
run in interpret mode, against the sweep of every triangle, and the
route that takes it against the regen goldens.

The port lists each 256-lane block's reachable tiles from every step's
state, as JAX's _step_lists does on the host at its own block size. A
list leaves out only tiles whose inflated box no live lane of the block
meets, so the two packages' lists fold the same winners. Bounds: the
plain version against JAX as tests/test_torch_tri_regen.py holds the
sweep (ROADMAP.md queue C: JAX's search roots come from bf16 splits and
its f32 chains are contracted into FMAs); the listed mode against the
sweep bit for bit; the route against the regen goldens within the golden
suite's own rtol 1e-5 / atol 1e-6.
"""
import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh_scene
from tpu_ray.kernels.bounce_step import BLOCK_R as JBLOCK_R
from tpu_ray.kernels.bounce_step import _fused_tables
from tpu_ray.kernels.bounce_step import permute_scene as jpermute_scene
from tpu_ray.kernels.regen import (_list_mode, _step_lists, _wave_init,
                                   regen_step)
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, make_trimesh_scene
from tpu_ray_torch.kernels import regen
from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, tab_tile_boxes,
                                               tri_tile_boxes)
from tpu_ray_torch.kernels.regen import (regen_record, regen_steps,
                                         regen_steps_plain, regen_tables,
                                         wave_init)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
OBJ = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
MB = 5
W, H = 32, 24
KW = dict(use_sky=True, max_bounces=MB, width=W, height=H)


def _scenes(name):
    """(JAX scene, port scene on the CPU): objico, or trimesh at
    subdivisions=1 (162 triangles in two tiles)."""
    if name == "objico":
        return (jmake_scene(f"obj:{OBJ}"),
                make_scene(f"obj:{OBJ}", device="cpu"))
    return (jmake_trimesh_scene(subdivisions=1),
            make_trimesh_scene(subdivisions=1, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_listed(name, steps=2):
    """JAX's listed regen route on the permuted scene for ``steps`` steps
    from one _wave_init state (exact argmin, lists rebuilt every step) ->
    (first state [24, R_pad], last state, records [steps, R_pad], cam13,
    r)."""
    js, _ = _scenes(name)
    jp = jpermute_scene(js)
    tb = _fused_tables(jp)
    perm, _ = jtile_order(W, H)
    st0, cam, r = _wave_init(jdefault_camera(js), jnp.asarray(perm), 1, 0,
                             0, W, H, JBLOCK_R)
    use_list, grp = _list_mode(tb, st0.shape[1], JBLOCK_R)
    assert use_list, "JAX lists this resident scene's tiles"
    st, recs = st0, []
    for _ in range(steps):
        st, rec = regen_step(
            cam, tb["t48"], tb["stab_full"], st, tb["tri_full"],
            _step_lists(tb, st, JBLOCK_R, grp), use_sky=jp.use_sky,
            max_bounces=MB, width=W, height=H, exact_argmin=True,
            with_idx=True, group=grp)
        recs.append(np.asarray(rec).reshape(-1))
    return (np.array(st0), np.array(st), np.stack(recs),
            np.array(cam)[0], r)


def _port_tables(name):
    table, tri, n_tri = regen_tables(_scenes(name)[1])
    return table, tri, n_tri, tab_tile_boxes(tri)


@pytest.mark.parametrize("name", ["objico", "trimesh"])
def test_listed_plain_matches_pallas(name):
    """regen_steps_plain in the listed mode against JAX
    regen_step(tri_lists=_step_lists(...)) (#4, _regen_list_kernel) in
    interpret mode: 2 steps from one _wave_init state at 32x24, 1 spp."""
    st0, out, recs, cam, r = _jax_listed(name)
    table, tri, n_tri, boxes = _port_tables(name)
    st = torch.as_tensor(st0)
    _, got = regen_steps_plain(st, torch.as_tensor(cam), table, 2, seg=1,
                               tri=tri, boxes=boxes, **KW)
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


@pytest.mark.parametrize("name", ["objico", "trimesh"])
def test_listed_plain_equals_sweep(name):
    """On that state the listed mode gives the sweep's state and records
    bit for bit, over all 5 steps of its sample: the lists leave out no
    winner; and a block lists fewer tiles than the scene holds."""
    st0 = torch.as_tensor(_jax_listed(name)[0])
    cam = torch.as_tensor(_jax_listed(name)[3])
    table, tri, _, boxes = _port_tables(name)
    a, b = st0.clone(), st0.clone()
    _, ra = regen_steps_plain(a, cam, table, MB, seg=2, tri=tri,
                              boxes=boxes, **KW)
    _, rb = regen_steps_plain(b, cam, table, MB, seg=2, tri=tri, **KW)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(ra.rec, rb.rec) and torch.equal(ra.t_end, rb.t_end)
    assert torch.equal(ra.chk.view(torch.int32), rb.chk.view(torch.int32))
    # the lists skip tiles: a sky-bound block reaches none of them
    reach = regen._block_reach(boxes, st0)
    assert int(reach.sum()) < reach.numel()


def test_listed_lanes_of_whole_blocks():
    """A slice of whole BLOCK_R-lane blocks lists as those blocks do in
    the full state, so the listed mode on the slice gives the full run's
    lanes bit for bit (the card check runs the plain version so)."""
    name = "trimesh"
    st0 = torch.as_tensor(_jax_listed(name)[0])
    cam = torch.as_tensor(_jax_listed(name)[3])
    table, tri, _, boxes = _port_tables(name)
    full = st0.clone()
    regen_steps_plain(full, cam, table, 3, tri=tri, boxes=boxes, **KW)
    lanes = torch.arange(st0.shape[1]).view(-1, BLOCK_R)[::2].reshape(-1)
    part = st0[:, lanes].contiguous()
    regen_steps_plain(part, cam, table, 3, tri=tri, boxes=boxes, **KW)
    assert torch.equal(part.view(torch.int32), full[:, lanes].view(
        torch.int32))


def test_tab_tile_boxes_equal_tri_tile_boxes():
    """The boxes from the search table are tri_tile_boxes' bit for bit."""
    for name in ("objico", "trimesh"):
        ts = _scenes(name)[1]
        table, tri, _, boxes = _port_tables(name)
        sp = regen.permute_scene(ts)
        assert torch.equal(boxes, tri_tile_boxes(sp.tris))


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_route_takes_listed_mode(monkeypatch, name):
    """fused + regen at 32x24, 1 spp takes the listed mode (the tile boxes
    reach the plain version's every call) and renders the JAX regen
    route's frozen image (exact argmin): rays exact, image within the
    golden suite's own bound."""
    calls = []
    plain = regen.regen_steps_plain

    def spy(*args, **kwargs):
        calls.append(kwargs.get("boxes"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(regen, "regen_steps_plain", spy)
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-regen-exact.npz"))
    ts = make_scene(f"obj:{OBJ}" if name == "objico" else name,
                    device="cpu")
    img, rays = render_pass(ts, default_camera(ts), width=W, height=H,
                            spp=1, seed=0, backend="fused", regen=True)
    assert calls and all(c is not None for c in calls)
    assert calls[0].shape == (ts.tris.n_pad // 128, 6)
    assert rays == int(z["rays"])
    np.testing.assert_allclose(img.numpy(), z["image"], rtol=1e-5,
                               atol=1e-6)


def test_listed_recording_and_arguments():
    """The listed recording forward advances the state as the listed
    forward does; stats are the kernel's alone, and boxes or stats
    without a triangle table raise."""
    ts = make_trimesh_scene(subdivisions=1, device="cpu")
    table, tri, n_tri = regen_tables(ts)
    boxes = tab_tile_boxes(tri)
    perm, _ = tile_order(32, 16)
    st, cam, _ = wave_init(default_camera(ts), torch.as_tensor(perm), 1, 0,
                           0, 32, 16)
    kw = dict(use_sky=True, max_bounces=MB, width=32, height=16)
    a, b = st.clone(), st.clone()
    regen_steps(a, cam, table, MB, tri=tri, boxes=boxes, **kw)
    recs = regen_record(b, cam, table, MB, 2, tri=tri, boxes=boxes, **kw)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(recs.t_end.sum()) == int(a[22].sum())
    assert (recs.rec >= table.shape[0] - n_tri).any()
    stats = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        regen_steps(st.clone(), cam, table, 1, tri=tri, boxes=boxes,
                    stats=stats, **kw)
    with pytest.raises(ValueError):
        regen._tri_args(None, boxes, None, table, torch.device("cpu"))
    with pytest.raises(ValueError):
        regen._tri_args(tri, None, stats, table, torch.device("cpu"))
