"""Port parity, the per-sample fused route on triangle scenes, forward:
the triangle-tile boxes and reachable-tile lists, the plain version of K8
``bounce_fwd_list`` and the triangle modes of the plain K5/K6
(kernels/bounce_step.py) against the JAX package's, whose Pallas kernels
run in interpret mode as tests/test_tri_list.py runs them; and the route
as a whole against the frozen goldens and the port's regen route.

The inputs of the kernel checks are JAX's own: the Morton-permuted scene
(small trimesh, ``make_trimesh_scene(subdivisions=2)``: 642 triangles in 6
tiles, and objico), the camera rays of a 48x32 tile-ordered wavefront and,
bounce after bounce, the states of JAX's exact-argmin ``bounce_fwd_list``;
each bounce hands the same state to both packages. Bounds, with their
reasons:

- tile boxes, lists: equal (the same f32 ops, none contracted).
- K8: winner ids equal on every lane; on lanes with equal ids rows 0-11
  within 1e-5 on at least 0.98 of lanes and within 1e-3 on all, rows 12-15
  bit for bit: the bound tests/test_torch_fused.py holds K4 to, for the
  same reason (XLA contracts FMAs and approximates rsqrt, ROADMAP.md
  queue C).
- K5, K6 with ``n_sph``: as tests/test_torch_fused.py holds them for
  spheres (K6 within rtol 1e-4 and 1e-4 of each group's max on the lanes
  whose K8 output agrees within 1e-5, 1e-3 over all).
- The route: rays exact and the image within the golden suite's rtol 1e-5
  / atol 1e-6 (measured max 3.6e-7 on trimesh, 6.0e-8 on objico); equal
  to the port's regen route bit for bit at these sizes (the lists' grazing
  acceptance fuzz, ``tri_block_lists``, does not occur here).

tests/test_torch_cuda.py holds the kernels against these plain versions
on the card.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.kernels import bounce_step as J
from tpu_ray.models.path_tracer import tile_order as jtile_order
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, make_trimesh_scene
from tpu_ray_torch.kernels.bounce_step import (
    TRI_BLOCK_M, bounce_bwd, bounce_bwd_plain, bounce_fwd_list,
    bounce_fwd_list_plain, bounce_replay, bounce_replay_plain, fused_tables,
    init_state, origin_bound, permute_scene, tri_block_lists,
    tri_tile_bounds, tri_tile_boxes)
from tpu_ray_torch.models.path_tracer import render_pass, tile_order
from tpu_ray_torch.ops.intersect import nearest_hit
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri
from tpu_ray_torch.ops.raygen import camera_rays
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
OBJ = os.path.join(ROOT, "tests", "fixtures", "ico1.obj")
W, H, MB = 48, 32, 3
JBR = J.BLOCK_R
FUSED = dict(backend="fused", regen=False)


def _scenes(name):
    """(JAX scene, port scene) of a test scene, neither permuted."""
    if name == "small":
        return (jmake_trimesh(subdivisions=2),
                make_trimesh_scene(subdivisions=2, device="cpu"))
    full = f"obj:{OBJ}" if name == "objico" else name
    return jmake_scene(full), make_scene(full, device="cpu")


def _cam_bound(ts):
    """fused_tables' origin bound: the default camera's |position|_inf."""
    return origin_bound(default_camera(ts).position[None])


@pytest.fixture(scope="module")
def jax_chain():
    """For small trimesh and objico: JAX's permuted scene and tables, and
    the input state and winner ids of each of MB bounces of JAX's
    exact-argmin bounce_fwd_list (lists at its BLOCK_R, group 1) from a
    48x32 camera wavefront."""
    out = {}
    for name in ("small", "objico"):
        js = J.permute_scene(_scenes(name)[0])
        tb = J._fused_tables(js)
        px = jnp.asarray(jtile_order(W, H)[0])
        o, d, base = jcamera_rays(jdefault_camera(js), W, H, px, 0, 0)
        st, r, _ = J._init_state(o, d, base, JBR)
        states, idxs = [], []
        for b in range(MB):
            states.append(np.asarray(st)[:, :r])
            lists = J.tri_block_lists(tb["tri_boxes"], st, JBR, 1)
            st, idx = J.bounce_fwd_list(
                tb["t48"], tb["stab_full"], st, jnp.int32(b), tb["tri_full"],
                lists, use_sky=js.use_sky, exact_argmin=True)
            idxs.append(np.asarray(idx)[:r])
        ts = _scenes(name)[1]
        out[name] = dict(js=js, tb=tb, r=r, states=states, idxs=idxs,
                         final=np.asarray(st)[:, :r], use_sky=js.use_sky,
                         ftb=fused_tables(ts, _cam_bound(ts)))
    return out


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_tri_tile_boxes_match_jax(name):
    """The permuted soup's tile bounds and inflated boxes, bit for bit."""
    js, ts = _scenes(name)
    jt, tt = J.permute_scene(js).tris, permute_scene(ts).tris
    for got, want in zip(tri_tile_bounds(tt), J.tri_tile_bounds(jt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    boxes = tri_tile_boxes(tt)
    assert boxes.shape == (tt.n_pad // TRI_BLOCK_M, 6)
    np.testing.assert_array_equal(boxes.numpy(),
                                  np.asarray(J.tri_tile_boxes(jt)))
    np.testing.assert_array_equal(fused_tables(ts, _cam_bound(ts)).boxes
                                  .numpy(),
                                  boxes.numpy())


@pytest.fixture(scope="module")
def trimesh_states():
    """trimesh's per-sample tables, and a primary and a once-bounced state
    of a 128x64 tile-ordered wavefront (8 blocks of JAX's 1024 lanes),
    bounced by the port's plain K8."""
    ts = make_scene("trimesh", device="cpu")
    tb = fused_tables(ts, _cam_bound(ts))
    px = torch.as_tensor(tile_order(128, 64)[0])
    st0 = init_state(*camera_rays(default_camera(ts), 128, 64, px, 0, 0))
    st1, _ = bounce_fwd_list_plain(st0, tb.table, tb.tri, tb.boxes, 0,
                                   n_sph=tb.n_sph, use_sky=True)
    return tb, (st0, st1)


@pytest.mark.parametrize("group", [1, 4])
def test_tri_block_lists_match_jax(trimesh_states, group):
    """cnt and lst equal to JAX's at its BLOCK_R = 1024, on a primary and a
    once-bounced state (group 4: two list rows, the last one padded)."""
    tb, states = trimesh_states
    jboxes = jnp.asarray(tb.boxes.numpy())
    for st in states:
        cnt, lst = tri_block_lists(tb.boxes, st, JBR, group)
        jcnt, jlst = J.tri_block_lists(jboxes, jnp.asarray(st.numpy()), JBR,
                                       group)
        assert cnt.shape == (-(-8 // group), 1)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(lst.numpy(), np.asarray(jlst))


def test_lists_are_conservative_and_cull(trimesh_states):
    """At the port's 256-lane block, on the first 16 blocks of each
    state: the tile of every lane's winner over ALL triangles is in its
    block's list, so K8's plain version finds the full sweep's winners;
    and the lists cull tiles."""
    tb, states = trimesh_states
    n_t = tb.boxes.shape[0]
    for b, st in enumerate(states):
        st = st[:, :16 * 256].contiguous()
        cnt, lst = tri_block_lists(tb.boxes, st)
        listed = [set(lst[k, :cnt[k, 0]].tolist()) for k in range(len(cnt))]
        o, d = st[0:3].T, st[3:6].T
        hit = nearest_hit(tb.table[:tb.n_sph, 0:3], tb.table[:tb.n_sph, 3],
                          o, d)
        th = nearest_hit_tri(tb.tri, o, d)
        wins = (th.t < hit.t) & (st[12] > 0.5)
        for lane in torch.nonzero(wins)[:, 0].tolist():
            tile = int(th.idx[lane]) // TRI_BLOCK_M
            assert tile in listed[lane // 256], (b, lane, tile)
        _, idx = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, b,
                                       n_sph=tb.n_sph, use_sky=True)
        full = torch.where(wins, th.idx.long() + tb.n_sph, hit.idx.long())
        live = (st[12] > 0.5) & ((th.t < 1e30) | (hit.t < 1e30))
        assert torch.equal(idx.long(), torch.where(live, full, -1))
        assert bool(wins.any())
        assert cnt.float().mean() < 0.9 * n_t, (b, cnt.float().mean())


def _assert_state_close(got, want, b):
    err = np.abs(got[0:12] - want[0:12])
    close = (err <= 1e-5).all(axis=0)
    assert close.mean() >= 0.98, (b, close.mean())
    assert err.max() <= 1e-3, (b, err.max())
    np.testing.assert_array_equal(got[12:16].view(np.uint32),
                                  want[12:16].view(np.uint32))


@pytest.mark.parametrize("name", ["small", "objico"])
def test_k8_plain_matches_jax(jax_chain, name):
    ref = jax_chain[name]
    ftb = ref["ftb"]
    assert ftb.n_sph == ref["js"].n_pad
    assert ftb.tri.shape[0] == ref["js"].tris.n_pad
    nexts = ref["states"][1:] + [ref["final"]]
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_list_plain(st, ftb.table, ftb.tri, ftb.boxes,
                                         b, n_sph=ftb.n_sph,
                                         use_sky=ref["use_sky"])
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), ref["idxs"][b])
        _assert_state_close(out.numpy(), nexts[b], b)
    assert (np.stack(ref["idxs"]) >= ftb.n_sph).mean() > 0.1


@pytest.mark.parametrize("name", ["small", "objico"])
def test_k5_tri_plain_matches_jax(jax_chain, name):
    """bounce_replay_plain with n_sph against JAX bounce_replay(n_pad=...)
    given JAX's ids, and replaying K8's plain version bit for bit."""
    ref = jax_chain[name]
    ftb = ref["ftb"]
    kw = dict(n_sph=ftb.n_sph, use_sky=ref["use_sky"])
    tb = ref["tb"]
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_list_plain(st, ftb.table, ftb.tri, ftb.boxes,
                                         b, **kw)
        rep = bounce_replay_plain(st, ftb.table, idx, b, **kw)
        assert torch.equal(rep.view(torch.int32), out.view(torch.int32))
    b = 1
    jst = np.zeros((16, -(-ref["r"] // JBR) * JBR), np.float32)
    jst[:, :ref["r"]] = ref["states"][b]
    jidx = np.full(jst.shape[1], -1, np.int32)
    jidx[:ref["r"]] = ref["idxs"][b]
    want = np.asarray(J.bounce_replay(
        tb["t48"], jnp.asarray(jst), jnp.asarray(jidx), jnp.int32(b),
        use_sky=ref["use_sky"], n_pad=ftb.n_sph))[:, :ref["r"]]
    got = bounce_replay_plain(torch.as_tensor(ref["states"][b].copy()),
                              ftb.table,
                              torch.as_tensor(ref["idxs"][b].copy()), b,
                              **kw)
    _assert_state_close(got.numpy(), want, b)


def _assert_grads_close(d_st, d_tab, jd, jt, rtol, tol):
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)):
        want = jd[rows]
        np.testing.assert_allclose(d_st[rows], want, rtol=rtol,
                                   atol=tol * np.abs(want).max())
    for cols in (slice(0, 3), 3, slice(4, 7), slice(7, 10), 10, 11):
        want = jt[:, cols]
        np.testing.assert_allclose(d_tab[:, cols], want, rtol=rtol,
                                   atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("bounce", [0, 1])
def test_k6_tri_plain_matches_jax(jax_chain, bounce):
    """small trimesh: d_state rows 0-11 and d_table (triangle rows
    included) against JAX bounce_bwd(n_pad=...)."""
    ref = jax_chain["small"]
    ftb, tb, r = ref["ftb"], ref["tb"], ref["r"]
    st, jidx = ref["states"][bounce], ref["idxs"][bounce]
    nxt = (ref["states"] + [ref["final"]])[bounce + 1]
    out, _ = bounce_fwd_list_plain(torch.as_tensor(st.copy()), ftb.table,
                                   ftb.tri, ftb.boxes, bounce,
                                   n_sph=ftb.n_sph, use_sky=True)
    agree = (np.abs(out.numpy()[0:12] - nxt[0:12]) <= 1e-5).all(axis=0)
    assert agree.mean() >= 0.98
    r_pad = -(-r // JBR) * JBR
    jst = np.zeros((16, r_pad), np.float32)
    jst[:, :r] = st
    jid = np.full(r_pad, -1, np.int32)
    jid[:r] = jidx
    g_all = np.random.default_rng(bounce).standard_normal((16, r)).astype(
        np.float32)
    g_all[12:16] = 0.0
    for g, rtol, tol in ((g_all * agree, 1e-4, 1e-4), (g_all, 1e-3, 1e-3)):
        jg = np.zeros((16, r_pad), np.float32)
        jg[:, :r] = g
        jd, jt = J.bounce_bwd(tb["t48"], jnp.asarray(jst), jnp.asarray(jid),
                              jnp.int32(bounce), jnp.asarray(jg),
                              use_sky=True, n_pad=ftb.n_sph)
        d_st, d_tab = bounce_bwd_plain(
            torch.as_tensor(st.copy()), ftb.table,
            torch.as_tensor(jidx.copy()), bounce, torch.as_tensor(g.copy()),
            use_sky=True, n_sph=ftb.n_sph)
        _assert_grads_close(d_st.numpy()[0:12], d_tab.numpy(),
                            np.asarray(jd)[0:12, :r],
                            np.asarray(jt)[0:12].T, rtol, tol)
        assert np.abs(d_tab.numpy()[ftb.n_sph:, 0:4]).max() > 0


def test_wrappers_take_plain_on_cpu(jax_chain):
    ref = jax_chain["small"]
    ftb = ref["ftb"]
    kw = dict(n_sph=ftb.n_sph, use_sky=True)
    st = torch.as_tensor(ref["states"][1].copy())
    before = (bounce_fwd_list.launches, bounce_replay.launches,
              bounce_bwd.launches)
    out, idx = bounce_fwd_list(st, ftb.table, ftb.tri, ftb.boxes, 1, **kw)
    want = bounce_fwd_list_plain(st, ftb.table, ftb.tri, ftb.boxes, 1, **kw)
    assert torch.equal(idx, want[1])
    assert torch.equal(out.view(torch.int32), want[0].view(torch.int32))
    rep = bounce_replay(st, ftb.table, idx, 1, **kw)
    assert torch.equal(rep.view(torch.int32), out.view(torch.int32))
    d_out = torch.ones_like(st)
    d_st, _ = bounce_bwd(st, ftb.table, idx, 1, d_out, **kw)
    assert d_st is d_out
    assert (bounce_fwd_list.launches, bounce_replay.launches,
            bounce_bwd.launches) == before


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_route_matches_golden(name):
    """fused without regen at 32x24, 1 spp against the JAX exact-argmin
    fused route's frozen render: rays exact, image within the golden
    suite's own bound."""
    z = np.load(os.path.join(GOLDEN_DIR, f"{name}-fused-exact.npz"))
    ts = _scenes(name)[1]
    img, rays = render_pass(ts, default_camera(ts), width=32, height=24,
                            spp=1, seed=0, **FUSED)
    assert rays == int(z["rays"])
    np.testing.assert_allclose(img.numpy(), z["image"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["trimesh", "objico"])
def test_route_matches_regen_route(name):
    """The per-sample route renders the regen route's image and rays bit
    for bit (the same permuted scene, search and shading, and per-pixel
    sample order); cull_secondary changes nothing on a triangle scene."""
    ts = _scenes(name)[1]
    cam = default_camera(ts)
    kw = dict(width=24, height=16, spp=2, sample_start=1)
    a, ra = render_pass(ts, cam, **FUSED, **kw)
    b, rb = render_pass(ts, cam, backend="fused", regen=True, **kw)
    c, rc = render_pass(ts, cam, cull_secondary=True, **FUSED, **kw)
    assert ra == rb == rc
    assert torch.equal(a, b) and torch.equal(a, c)


def test_cli_render_no_regen_triangles(tmp_path, capsys):
    z = np.load(os.path.join(GOLDEN_DIR, "trimesh-fused-exact.npz"))
    out = tmp_path / "t.png"
    assert cli.main(["render", "--scene", "trimesh", "--device", "cpu",
                     "--width", "32", "--height", "24", "--spp", "1",
                     "--backend", "fused", "--no-regen", "--exact-argmin",
                     "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"{int(z['rays'])} rays" in capsys.readouterr().err
    assert cli.main(["render", "--scene", f"obj:{OBJ}", "--device", "cpu",
                     "--width", "8", "--height", "8", "--spp", "1",
                     "--backend", "fused", "--no-regen",
                     "--out", str(out)]) == 0
