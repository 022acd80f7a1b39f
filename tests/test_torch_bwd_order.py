"""The fixed order of K3's and K6's d_table sums as a plain function,
``bounce_step.table_sum_fixed_order``: against the f64 sum of the plain
versions, bit for bit against a sum ordered by hand, and its counts.
No JAX: the order is the port's own (``csrc/shade.cuh``)."""
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.bounce_step import (
    MERGE_STATS, bounce_bwd, bounce_bwd_lanes_plain, bounce_bwd_plain,
    bounce_fwd_plain, init_state, morton_perm, permute_spheres, scene_table,
    table_sum_fixed_order)
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.raygen import camera_rays


def _f64_sum(keys, d_w, n):
    """The plain versions' sum: index_add_ in f64 over the keyed lanes."""
    out = torch.zeros((n, 12), dtype=torch.float64)
    for s in range(keys.shape[0]):
        on = keys[s] >= 0
        out.index_add_(0, keys[s][on].long(),
                       d_w[s][:, on].T.to(torch.float64))
    return out


@pytest.mark.parametrize("r,steps,threads,parts", [
    (300, 1, 256, 256),     # K6: one tile a block
    (700, 3, 64, 4),        # K3's shape: several tiles and steps a block
    (513, 2, 128, 2)])      # ragged last tile
def test_fixed_order_matches_f64_sum(r, steps, threads, parts):
    g = np.random.default_rng(r)
    n = 40
    keys = torch.as_tensor(g.integers(-8, n, (steps, r)), dtype=torch.int32)
    d_w = torch.as_tensor(g.standard_normal((steps, 12, r)),
                          dtype=torch.float32)
    got = table_sum_fixed_order(keys, d_w, n, threads=threads, parts=parts)
    want = _f64_sum(keys, d_w, n)
    assert got.dtype == torch.float32 and got.shape == (n, 12)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-6 * want.abs().max().item()
    untouched = torch.ones(n, dtype=torch.bool)
    untouched[keys[keys >= 0].long()] = False
    assert torch.equal(got[untouched].view(torch.int32),
                       torch.zeros_like(got[untouched]).view(torch.int32))


def test_fixed_order_by_hand():
    """Key 5 in warps 0, 1 and 3 of a 128-lane tile (lanes 3 and 7, 32,
    97 and 98), then again in a second tile of the same block (lane 130),
    and key 2 in a tile of the second block: each warp's lanes summed in
    lane order from +0.0, the warps' sums added in warp order, the tiles in
    order, then the blocks in order from +0.0, all in f32."""
    f = np.float32
    r, n = 4 * 128, 8
    keys = torch.full((r,), -1, dtype=torch.int32)
    vals = {3: 1e8, 7: 1.0, 32: -1e8, 97: 3.0, 98: 0.5, 130: 0.25,
            200: 7.0}
    for lane in vals:
        keys[lane] = 2 if lane == 200 else 5
    d_w = torch.zeros((12, r), dtype=torch.float32)
    for lane, v in vals.items():
        d_w[:, lane] = torch.arange(1, 13, dtype=torch.float32) * v
    got = table_sum_fixed_order(keys, d_w, n, threads=128, parts=2)
    # block 0 takes tiles 0 and 2 (lanes 0-127, 256-383), block 1 tiles 1
    # and 3: lane 130 and 200 lie in tile 1, so block 1
    col = np.arange(1, 13, dtype=f)
    v = {lane: col * f(x) for lane, x in vals.items()}
    zero = np.zeros(12, dtype=f)
    w0 = (zero + v[3]) + v[7]
    w1 = zero + v[32]
    w3 = (zero + v[97]) + v[98]
    row0_5 = ((zero + w0) + w1) + w3
    row1_5 = zero + v[130]
    row1_2 = zero + v[200]
    want = np.zeros((n, 12), dtype=f)
    want[5] = (zero + row0_5) + row1_5
    want[2] = (zero + zero) + row1_2
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    # the associations differ: 1e8 + 1 - 1e8 is not 1 in f32
    assert not np.array_equal(want[5], (zero + v[3]) + ((v[7] + v[32])
                                                         + (v[97] + v[98]))
                              + v[130])
    _, counts = table_sum_fixed_order(keys, d_w, n, threads=128, parts=2,
                                      counts=True)
    # 4 tiles merged; warp sums: tile 0's warps 0, 1, 3, tile 1's warp 0
    # (lane 130) and warp 2 (lane 200); entries written: key 5 in tile 0,
    # keys 5 and 2 in tile 1; rows touched: 1 + 2, at most 2 a block
    assert counts.tolist() == [4, 5, 3, 3, 2]
    assert counts.shape == (MERGE_STATS,)


def test_fixed_order_on_k6_lanes():
    """K6's plain lane terms through the fixed order: within 1e-6 of each
    column's max of bounce_bwd_plain's f64 d_table, every bounce of
    rtweekend at 48x32, one 256-lane tile a block and several; the plain
    d_table is the lanes' f64 sum."""
    ts = make_scene("rtweekend", device="cpu")
    ts = permute_spheres(ts, morton_perm(ts))
    table = scene_table(ts)
    px = torch.as_tensor(tile_order(48, 32)[0])
    st = init_state(*camera_rays(default_camera(ts), 48, 32, px, 0, 0))
    g = np.random.default_rng(4)
    for b in range(3):
        nxt, idx = bounce_fwd_plain(st, table, b, use_sky=True)
        d_out = torch.as_tensor(g.standard_normal(st.shape),
                                dtype=torch.float32)
        d_out[12:16] = 0.0
        d_st, d_wn = bounce_bwd_lanes_plain(st, table, idx, b, d_out,
                                            use_sky=True)
        d_p, tab_p = bounce_bwd(st, table, idx, b, d_out.clone(),
                                use_sky=True)
        assert torch.equal(d_st, d_p)
        live = idx >= 0
        want = torch.zeros(table.shape, dtype=torch.float64)
        want.index_add_(0, idx[live].long(), d_wn[:, live].T.double())
        assert torch.equal(tab_p, want.float())
        for parts in (6, 2):
            got = table_sum_fixed_order(idx, d_wn, table.shape[0],
                                        threads=256, parts=parts)
            tol = 1e-6 * want.abs().amax(dim=0)
            assert bool(((got.double() - want).abs() <= tol).all())
        st = nxt


def test_stats_are_the_kernels():
    """On CPU tensors the wrappers take the plain versions, which count
    nothing: stats are refused there."""
    st = torch.zeros((16, 4))
    table = torch.zeros((2, 12))
    idx = torch.full((4,), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        bounce_bwd(st, table, idx, 0, st.clone(), use_sky=True,
                   stats=torch.zeros(MERGE_STATS, dtype=torch.int64))
    assert torch.equal(bounce_bwd_plain(st, table, idx, 0, st.clone(),
                                        use_sky=True)[1],
                       torch.zeros_like(table))
