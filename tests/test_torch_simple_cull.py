"""K9's culled searches in its plain version (kernels/simple_shade.py
``simple_trace_plain``, the function K9 is held to on the card): the
spheres folded over their Morton tiles (``sph=``, ``regen.sphere_tiles``)
and the triangles of the per-block primary and shadow lists.

Bounds, with their reasons:
- The sphere-tile fold against the fold over every slot: bit for bit (a
  tile is skipped only where its inflated box lies past the lane's best
  hit, which cannot hold a nearer one; ``regen.sphere_tiles``).
- The shadow lists against the sweep of every tile, winner by winner: a
  lane may differ only where the sweep's hit lies outside its tile's
  inflated box (Möller-Trumbore's grazing acceptance, the fuzz every
  list of the port allows); the outputs bit for bit here.
- The counters against the lists built apart (``tri_block_lists``): equal.
"""
import pytest
import torch

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, make_trilight_scene
from tpu_ray_torch.kernels.bounce_step import (BLOCK_R, TRI_BLOCK_M,
                                               init_state, nearest_prim,
                                               origin_bound, tri_block_lists)
from tpu_ray_torch.kernels.regen import cam13
from tpu_ray_torch.kernels.simple_shade import (N_STATS, lane_rows,
                                                simple_tables,
                                                simple_trace_plain)
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.intersect_tri import nearest_hit_tri
from tpu_ray_torch.ops.shading_modes import scene_light_indices
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

W, H = 32, 16


def _inputs(name, flat, lights=None):
    """K9's inputs for the scene at W x H, 2 spp from sample 1: (args,
    kw, the sphere tiles)."""
    sc = (make_trilight_scene(device="cpu") if name == "trilight"
          else make_scene(name, device="cpu"))
    cam = default_camera(sc)
    if lights is None:
        lights = () if flat else scene_light_indices(sc)
    tb = simple_tables(sc, lights, origin_bound(cam.position[None]))
    px = torch.as_tensor(tile_order(W, H)[0])
    args = (lane_rows(px, W, 0), cam13(cam, 3), tb["table"], tb["tri"],
            tb["boxes"], tb["lidx"], tb["ldat"])
    kw = dict(n_sph=tb["n_sph"], spp=2, s0=1, width=W, height=H,
              use_sky=tb["use_sky"], flat=flat)
    return args, kw, tb["sph"]


@pytest.mark.parametrize("name,flat", [("sixteen", False),
                                       ("rtweekend", False),
                                       ("rtweekend", True)])
def test_sphere_tiles_fold_equals_every_slot(name, flat):
    """The fold over the Morton sphere tiles gives the fold over all n_pad
    slots bit for bit, and tests fewer pairs than the real spheres'."""
    args, kw, sph = _inputs(name, flat)
    stats = torch.zeros(N_STATS, dtype=torch.int64)
    culled = simple_trace_plain(*args, **kw, sph=sph, stats=stats)
    every = simple_trace_plain(*args, **kw)
    assert torch.equal(culled, every)
    searches = int(culled[3].sum())
    n_real = int((args[2][:kw["n_sph"], 3] > 0).sum())
    boxes, tiles, pairs = stats[5:8].tolist()
    assert 0 < pairs < searches * n_real and 0 < tiles <= pairs
    assert boxes >= tiles
    assert stats[:5].tolist() == [0] * 5      # no triangles


def _shadow_winners_check(args, folds, n_sph):
    """Each sample's shadow search (its second) on its block lists against
    the sweep of every tile -> (searches, winners differing); a differing
    winner's sweep hit must lie outside its tile's inflated box."""
    table, tri, boxes = args[2], args[3], args[4]
    n = n_diff = 0
    for o, d, tiles, act in folds[1::2]:
        assert tiles is not None
        ray = init_state(o.T, d.T, torch.zeros_like(act, dtype=torch.int64))
        listed = nearest_prim(ray, table, tri, tiles)
        swept = nearest_prim(ray, table, tri, None)
        th = nearest_hit_tri(tri, o.T, d.T)
        pt = o.T + d.T * th.t[:, None]
        bx = boxes[th.idx.long() // TRI_BLOCK_M]
        inside = (swept >= n_sph) & ((pt >= bx[:, 0:3])
                                     & (pt <= bx[:, 3:6])).all(1)
        diff = act & (listed != swept)
        assert not bool((diff & inside).any())
        n += int(act.sum())
        n_diff += int(diff.sum())
    return n, n_diff


@pytest.mark.parametrize("name,lights", [("trilight", None),
                                         ("trimesh", (0,))])
def test_shadow_lists_against_sweep(name, lights):
    """Lambert on trilight (its light) and on trimesh (its sphere as the
    light: 81 tiles): the shadow folds over their blocks' lists find the
    sweep's winners (none may differ where the sweep's hit lies inside its
    tile's box; none differs here), the output equals the sweep of every
    tile, and the counters equal the lists built apart."""
    args, kw, sph = _inputs(name, False, lights)
    folds, stats = [], torch.zeros(N_STATS, dtype=torch.int64)
    listed = simple_trace_plain(*args, **kw, sph=sph, folds=folds,
                                stats=stats)
    swept = simple_trace_plain(*args[:4], None, *args[5:], **kw, sph=sph)
    assert torch.equal(listed, swept)
    n, n_diff = _shadow_winners_check(args, folds, kw["n_sph"])
    assert n > 0 and n_diff == 0
    # the counters: each fold's lists, built apart from its rays
    boxes, r = args[4], args[0].shape[1]
    want = [0, 0, 0, 0]
    for k, (o, d, _, act) in enumerate(folds):
        st = init_state(o.T, d.T, torch.zeros(r, dtype=torch.int64))
        st[12] = act.float()
        cnt, _ = tri_block_lists(boxes, st)
        live = act.reshape(-1, BLOCK_R).any(1)
        want[k % 2] += int(cnt.sum())
        want[2 + k % 2] += int(live.sum())
    assert stats[:4].tolist() == want
    assert want[1] > 0 and want[3] > 0
    if name == "trimesh":
        assert want[1] < want[3] * boxes.shape[0]     # the lists cull


def test_lane_slice_runs_its_blocks_whole():
    """With shadow lists, a lane slice gives the full run's columns: its
    blocks run whole, as a shadow list is its whole block's."""
    args, kw, sph = _inputs("trimesh", False, (0,))
    full = simple_trace_plain(*args, **kw, sph=sph)
    lanes = torch.arange(5, args[0].shape[1], 37)
    assert torch.equal(simple_trace_plain(*args, **kw, sph=sph, lanes=lanes),
                       full[:, lanes])
    with pytest.raises(ValueError, match="whole launch"):
        simple_trace_plain(*args, **kw, lanes=lanes,
                           stats=torch.zeros(N_STATS, dtype=torch.int64))
