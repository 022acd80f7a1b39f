"""Port parity, the per-sample fused route's kernel layer: the Morton
permutation, the cull masks and the plain versions of K4 ``bounce_fwd``,
K5 ``bounce_replay`` and K6 ``bounce_bwd`` (kernels/bounce_step.py)
against the JAX package's, whose Pallas kernels run in interpret mode as
tests/test_fused.py runs them.

The inputs are JAX's own: the Morton-permuted scene, camera rays of a
64x32 tile-ordered wavefront and, bounce after bounce, the states of
JAX's exact-argmin ``bounce_fwd``; each bounce hands the same state to
both packages. Bounds, with their reasons:

- permutation and masks: equal.
- K4: winner ids equal except on near-ties (JAX's roots come from bf16x6
  split matmuls, the port's from the exact f32 chain), at least 0.995 of
  lanes (measured: all). On lanes with equal ids, rows 0-11 within 1e-5
  on at least 0.98 of lanes (tests/test_fused.py's bound and share, there
  over whole traces) and within 1e-3 on all; rows 12-15 bit for bit. XLA
  contracts FMAs and approximates rsqrt, the port rounds each f32 op
  (ROADMAP.md queue C), and the recomputed hit point of a grazing hit
  magnifies one ulp: measured on rtweekend's primary bounce, 27 of 2048
  lanes differ by more than 1e-5, at most 8.0e-5.
- K5: given K4's ids, K4's state bit for bit (the same function); against
  JAX ``bounce_replay`` given JAX's ids, as K4 against ``bounce_fwd``.
- K6: against JAX ``bounce_bwd`` given the same state, ids and cotangent
  on the lanes whose K4 output agrees within 1e-5 (the cotangent is zero
  elsewhere), d_state and d_table within rtol 1e-4 and 1e-4 of each
  group's max (the bound tests/test_regen_grad.py holds two regen routes'
  values to); over all lanes within 1e-3 of each group's max. A grazing
  hit's gradient is large (d_origin up to 2.1e3 at rtweekend's primary
  bounce) and magnifies the contraction differences: measured, one of
  2048 lanes there is off by 1.7e-4 of the group max.

tests/test_torch_cuda.py holds the kernels against these plain versions
on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels import bounce_step as J
from tpu_ray.models.path_tracer import tile_order as jtile_order
from tpu_ray.ops.raygen import camera_rays as jcamera_rays

from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.bounce_step import (
    BLOCK_N, bounce_bwd_plain, bounce_cull_mask, bounce_cull_mask_octant,
    bounce_fwd_plain, bounce_replay_plain, morton_perm, octant_occupancy,
    permute_spheres, ray_block_bounds, scene_table, tile_bounds)

SCENES = ["rgb", "randomized", "rtweekend"]
W, H, MB = 64, 32, 5
JBR = J.BLOCK_R


def _port_table(name):
    ts = make_scene(name, device="cpu")
    return scene_table(permute_spheres(ts, morton_perm(ts)))


@pytest.fixture(scope="module")
def jax_chain():
    """For each scene: JAX's Morton-permuted scene, its tables, and the
    input state and winner ids of each of MB bounces of JAX's exact
    bounce_fwd from a 64x32 camera wavefront."""
    out = {}
    for name in SCENES:
        js = J.permute_scene(jmake_scene(name))
        jc = jdefault_camera(js)
        px = jnp.asarray(jtile_order(W, H)[0])
        o, d, base = jcamera_rays(jc, W, H, px, 0, 0)
        tb = J._fused_tables(js)
        st, r, r_pad = J._init_state(o, d, base, JBR)
        assert r == r_pad == W * H
        states, idxs = [], []
        for b in range(MB):
            states.append(np.asarray(st))
            st, idx = J.bounce_fwd(tb["t48"], tb["stab_full"], st,
                                   jnp.int32(b), None, None,
                                   use_sky=js.use_sky, exact_argmin=True)
            idxs.append(np.asarray(idx))
        out[name] = dict(js=js, tb=tb, states=states, idxs=idxs,
                         final=np.asarray(st), use_sky=js.use_sky)
    return out


@pytest.mark.parametrize("name", SCENES)
def test_morton_perm_matches_jax(name):
    perm = morton_perm(make_scene(name, device="cpu")).numpy()
    np.testing.assert_array_equal(perm, np.asarray(J.morton_perm(
        jmake_scene(name))))
    # and the permuted table is the JAX permuted scene's
    js = J.permute_scene(jmake_scene(name))
    want = np.asarray(J.scene_table(js))[0:12].T
    np.testing.assert_array_equal(_port_table(name).numpy(), want)


@pytest.mark.parametrize("name", SCENES)
def test_cull_masks_match_jax(jax_chain, name):
    """Primary and octant masks at JAX's block_r (1024) on the primary
    state and on the state after one bounce, and the tile boxes."""
    ref = jax_chain[name]
    js = ref["js"]
    ts = make_scene(name, device="cpu")
    ts = permute_spheres(ts, morton_perm(ts))
    lo, hi = tile_bounds(ts)
    jlo, jhi = J.tile_bounds(js, BLOCK_N)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    for st in (ref["states"][0], ref["states"][1]):
        jst, tst = jnp.asarray(st), torch.as_tensor(st.copy())
        for got, want in zip(ray_block_bounds(tst, JBR),
                             J.ray_block_bounds(jst, JBR)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            bounce_cull_mask(ts, tst, JBR).numpy(),
            np.asarray(J.bounce_cull_mask(js, jst, JBR)))
        np.testing.assert_array_equal(
            octant_occupancy(tst, JBR).numpy(),
            np.asarray(J.octant_occupancy(jst, JBR)))
        np.testing.assert_array_equal(
            bounce_cull_mask_octant(ts, tst, JBR).numpy(),
            np.asarray(J.bounce_cull_mask_octant(js, jst, JBR)))


def test_masks_cull_tiles():
    """At the port's own ray block the primary mask of rtweekend skips
    tiles (so the culled kernel path is exercised), and after a bounce the
    octant mask keeps no tile that the plain mask culls (each octant's
    direction box lies inside the block's)."""
    ts = make_scene("rtweekend", device="cpu")
    ts = permute_spheres(ts, morton_perm(ts))
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.kernels.bounce_step import init_state
    from tpu_ray_torch.models.path_tracer import tile_order
    from tpu_ray_torch.ops.raygen import camera_rays
    px = torch.as_tensor(tile_order(128, 64)[0])
    st = init_state(*camera_rays(default_camera(ts), 128, 64, px, 0, 0))
    m0 = bounce_cull_mask(ts, st)
    assert m0.shape == (128 * 64 // 256, 4) and 0 < m0.float().mean() < 1
    st1, _ = bounce_fwd_plain(st, scene_table(ts), 0, use_sky=True)
    plain = bounce_cull_mask(ts, st1)
    octant = bounce_cull_mask_octant(ts, st1)
    assert (octant <= plain).all() and octant.float().mean() < 1


def _assert_state_close(got, want, b):
    err = np.abs(got[0:12] - want[0:12])
    close = (err <= 1e-5).all(axis=0)
    assert close.mean() >= 0.98, (b, close.mean())
    assert err.max() <= 1e-3, (b, err.max())
    # rows 12-15 (alive, rng base bits, the unused rows) exactly
    np.testing.assert_array_equal(got[12:16].view(np.uint32),
                                  want[12:16].view(np.uint32))


@pytest.mark.parametrize("name", SCENES)
def test_k4_plain_matches_jax(jax_chain, name):
    ref = jax_chain[name]
    table = _port_table(name)
    nexts = ref["states"][1:] + [ref["final"]]
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_plain(st, table, b, use_sky=ref["use_sky"])
        assert idx.dtype == torch.int32
        same = idx.numpy() == ref["idxs"][b]
        assert same.mean() >= 0.995, (b, same.mean())
        _assert_state_close(out.numpy()[:, same], nexts[b][:, same], b)


@pytest.mark.parametrize("name", SCENES)
def test_k4_plain_culled_equals_unculled(jax_chain, name):
    """The primary mask and the octant mask leave every bounce bit for bit
    as the unculled one (their conservative interval test)."""
    ref = jax_chain[name]
    ts = make_scene(name, device="cpu")
    ts = permute_spheres(ts, morton_perm(ts))
    table = scene_table(ts)
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_plain(st, table, b, use_sky=ref["use_sky"])
        mask = (bounce_cull_mask if b == 0 else bounce_cull_mask_octant)(
            ts, st)
        out_c, idx_c = bounce_fwd_plain(st, table, b, mask,
                                        use_sky=ref["use_sky"])
        assert torch.equal(idx, idx_c)
        assert torch.equal(out.view(torch.int32), out_c.view(torch.int32))


@pytest.mark.parametrize("name", SCENES)
def test_k5_plain_replays_k4_and_matches_jax(jax_chain, name):
    ref = jax_chain[name]
    table = _port_table(name)
    tb = ref["tb"]
    for b in range(MB):
        st = torch.as_tensor(ref["states"][b].copy())
        out, idx = bounce_fwd_plain(st, table, b, use_sky=ref["use_sky"])
        rep = bounce_replay_plain(st, table, idx, b, use_sky=ref["use_sky"])
        assert torch.equal(rep.view(torch.int32), out.view(torch.int32))
        if b in (0, 2):
            jidx = ref["idxs"][b]
            want = np.asarray(J.bounce_replay(
                tb["t48"], jnp.asarray(ref["states"][b]), jnp.asarray(jidx),
                jnp.int32(b), use_sky=ref["use_sky"]))
            got = bounce_replay_plain(st, table,
                                      torch.as_tensor(jidx.copy()), b,
                                      use_sky=ref["use_sky"]).numpy()
            _assert_state_close(got, want, b)


def _cotangent(r, seed):
    g = np.random.default_rng(seed).standard_normal((16, r)).astype(
        np.float32)
    g[12:16] = 0.0
    return g


def _assert_grads_close(d_st, d_tab, jd, jt, rtol, tol):
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12)):
        want = jd[rows]
        np.testing.assert_allclose(d_st[rows], want, rtol=rtol,
                                   atol=tol * np.abs(want).max())
    for cols in (slice(0, 3), 3, slice(4, 7), slice(7, 10), 10, 11):
        want = jt[:, cols]
        np.testing.assert_allclose(d_tab[:, cols], want, rtol=rtol,
                                   atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("bounce", [0, 1, 3])
def test_k6_plain_matches_jax(jax_chain, bounce):
    """rtweekend: d_state rows 0-11 and d_table against JAX bounce_bwd."""
    ref = jax_chain["rtweekend"]
    tb = ref["tb"]
    table = _port_table("rtweekend")
    st, jidx = ref["states"][bounce], ref["idxs"][bounce]
    nxt = (ref["states"] + [ref["final"]])[bounce + 1]
    out, _ = bounce_fwd_plain(torch.as_tensor(st.copy()), table, bounce,
                              use_sky=True)
    agree = (np.abs(out.numpy()[0:12] - nxt[0:12]) <= 1e-5).all(axis=0)
    assert agree.mean() >= 0.98
    g_all = _cotangent(st.shape[1], bounce)
    for g, rtol, tol in ((g_all * agree, 1e-4, 1e-4), (g_all, 1e-3, 1e-3)):
        jd, jt = J.bounce_bwd(tb["t48"], jnp.asarray(st), jnp.asarray(jidx),
                              jnp.int32(bounce), jnp.asarray(g),
                              use_sky=True)
        d_st, d_tab = bounce_bwd_plain(
            torch.as_tensor(st.copy()), table, torch.as_tensor(jidx.copy()),
            bounce, torch.as_tensor(g.copy()), use_sky=True)
        _assert_grads_close(d_st.numpy()[0:12], d_tab.numpy(),
                            np.asarray(jd)[0:12], np.asarray(jt)[0:12].T,
                            rtol, tol)
        assert np.abs(d_tab.numpy()).max() > 0
