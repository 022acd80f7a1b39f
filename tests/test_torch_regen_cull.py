"""K2's culled sphere search (kernels/regen.sphere_tiles,
nearest_sphere_culled, regen_steps_plain(sph=)): the Morton tiles of a
sphere table and their inflated boxes, the plain mirror of the kernel's
fold (common.cuh trt_fold_sph_tiles: the tiles in ascending order, a lane
folding a tile only where its ray enters the box at no more than its best)
held bit for bit against regen_steps_plain, which folds every sphere, an
exact tie in t across tiles, and the culled route's image against the
JAX package's regen_step in interpret mode.

Bounds: the mirror against regen_steps_plain exactly (state, records,
winners); against JAX the bounds of tests/test_torch_kernels.py's
test_k2_plain_matches_pallas (JAX's search roots come from bf16x6 splits
and its f32 chains are contracted into FMAs, so near-tie winners may
differ: ROADMAP.md queue C), the colour totals within 1e-3 relative over
the ten steps. tests/test_torch_cuda.py holds the kernel
against regen_steps_plain on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.kernels.bounce_step import BLOCK_R as JBLOCK_R, _fused_tables
from tpu_ray.kernels.bounce_step import permute_scene as jpermute_scene
from tpu_ray.kernels.regen import _wave_init, regen_step
from tpu_ray.models.path_tracer import tile_order as jtile_order

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels.regen import (SPH_GROUP, SPH_PAD, SPH_TILE,
                                         _box_entry,
                                         nearest_sphere_culled, regen_steps,
                                         regen_steps_plain, regen_tables,
                                         sphere_tiles, trace_regen,
                                         wave_init)
from tpu_ray_torch.kernels.bounce_step import nearest_prim
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.intersect import nearest_hit
from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)

W, H, SPP, MB = 32, 16, 2, 5


def _setup(name):
    ts = make_scene(name, device="cpu")
    table, _, _ = regen_tables(ts)
    cam = default_camera(ts)
    perm, _ = tile_order(W, H)
    st, c13, _ = wave_init(cam, torch.as_tensor(perm), SPP, 0, 0, W, H)
    sph = sphere_tiles(table, float(cam.position.abs().max()))
    kw = dict(use_sky=ts.use_sky, max_bounces=MB, width=W, height=H)
    return table, st, c13, sph, kw


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("name", ["rtweekend", "sixteen"])
def test_sphere_tiles_cover_the_table(name):
    """Tiles cover the table in ascending order, at most SPH_TILE spheres
    each; padding only in padding tiles, whose boxes are empty; each real
    sphere's box, padded, inside its tile's; the ground alone in a tile
    and in no other tile's box; o_lim bounds the scene and the camera; the
    groups of tiles and their boxes."""
    table, _, _, sph, _ = _setup(name)
    c, r = table[:, 0:3].double(), table[:, 3].double()
    starts = sph.starts.tolist()
    assert starts[0] == 0 and starts[-1] == table.shape[0] == sph.n
    assert all(0 < e - a <= SPH_TILE for a, e in zip(starts, starts[1:]))
    assert sph.o_lim >= float((c.abs().amax(dim=1) + r).max())
    ground = int(r.argmax())
    assert r[ground] > 100 * r[r > 0].median()
    boxes = sph.boxes.double()
    for t, (a, e) in enumerate(zip(starts, starts[1:])):
        lo, hi = boxes[t, 0:3], boxes[t, 3:6]
        real = r[a:e] > 0
        if not bool(real.any()):
            assert bool((lo > hi).all()), t          # empty: never entered
            continue
        assert bool(real.all()), f"tile {t} mixes padding and spheres"
        if a <= ground < e:
            assert e - a == 1
        else:
            # the neighbours' boxes stay near their own spheres
            assert float((hi - lo).max()) < float(r[ground]), t
        pad = SPH_PAD * sph.o_lim
        for j in range(a, e):
            assert bool((c[j] - r[j] - pad >= lo).all())
            assert bool((c[j] + r[j] + pad <= hi).all())
    # groups: consecutive tiles, at most SPH_GROUP, the ground's tile and
    # padding tiles alone; a group's box holds its tiles' boxes
    gs = sph.gstarts.tolist()
    assert gs[0] == 0 and gs[-1] == len(starts) - 1
    assert all(0 < e - a <= SPH_GROUP for a, e in zip(gs, gs[1:]))
    gb = sph.gboxes.double()
    for g, (a, e) in enumerate(zip(gs, gs[1:])):
        alone = [starts[t + 1] - starts[t] == 1 and starts[t] == ground
                 or not bool(r[starts[t]] > 0) for t in range(a, e)]
        assert e - a == 1 or not any(alone), g
        real = [t for t in range(a, e) if bool(r[starts[t]] > 0)]
        for t in real:
            assert bool((gb[g, 0:3] <= boxes[t, 0:3]).all())
            assert bool((gb[g, 3:6] >= boxes[t, 3:6]).all())


def test_box_entry_cases():
    """The slab entry: a box ahead, behind, around the origin, empty, met
    by a ray parallel to a face, and a NaN (a face through the origin of a
    ray with an overflowing reciprocal) taken as a possible entry at 0."""
    box = torch.tensor([1.0, -1.0, -1.0, 2.0, 1.0, 1.0])
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.5, 0.0, 0.0],
                      [0.0, 2.0, 0.0], [0.0, 0.5, 0.0], [1.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                      [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1e-39, 1.0, 0.0]])
    inv = torch.where(d != 0.0, torch.ones_like(d) / d, 0.0)
    got = _box_entry(box[None], o, d, inv)[:, 0].tolist()
    inf = float("inf")
    assert got[0:5] == [1.0, inf, 0.0, inf, 1.0]
    assert torch.isinf(inv[5, 0]) and got[5] == 0.0
    empty = torch.tensor([[1e30, 1e30, 1e30, -1e30, -1e30, -1e30]])
    assert bool(torch.isinf(_box_entry(empty, o, d, inv)).all())


@pytest.mark.parametrize("name", ["rtweekend", "rgb", "randomized",
                                  "sixteen"])
def test_culled_mirror_bit_equal_to_plain(name):
    """Every step of the 32x16, 2 spp route through the mirror of the
    culled search: the same state and records as the fold over every
    sphere, bit for bit, with fewer pairs tested."""
    table, st, c13, sph, kw = _setup(name)
    a, b = st.clone(), st.clone()
    steps = SPP * MB
    _, ra = regen_steps_plain(a, c13, table, steps, seg=4, **kw)
    stats = torch.zeros(3, dtype=torch.int64)
    _, rb = regen_steps_plain(b, c13, table, steps, seg=4, sph=sph,
                              stats=stats, **kw)
    assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(ra.rec, rb.rec) and torch.equal(ra.t_end, rb.t_end)
    assert torch.equal(_bits(ra.chk), _bits(rb.chk))
    boxes, folded, pairs = stats.tolist()
    live = int(a[22].sum())                    # one ray a live lane-step
    n_t, n_g = sph.boxes.shape[0], sph.gboxes.shape[0]
    assert live * n_g <= boxes <= live * (n_t + n_g)
    assert folded <= live * n_t and pairs <= folded * SPH_TILE
    assert pairs < live * table.shape[0] // 2


def test_lane_past_o_lim_folds_every_tile():
    """A lane whose origin lies past the bound the boxes were inflated for
    tests no box and folds every tile, with the plain fold's winner."""
    table, st, _, _, _ = _setup("rtweekend")
    sph = sphere_tiles(table)                   # the scene's bound alone
    far = st[:, :64].clone()
    far[0] = sph.o_lim * 2.0                    # far out on +x, facing -x
    far[3:6] = torch.tensor([-1.0, 0.0, 0.0])[:, None]
    idx, cnt = nearest_sphere_culled(far, table, sph)
    assert torch.equal(idx, nearest_prim(far, table))
    assert cnt[0] == 0 and cnt[1] == 64 * sph.boxes.shape[0]


def test_exact_tie_across_tiles():
    """Two spheres with one centre and radius, ids 3 and 20, in different
    tiles, so every ray that meets them meets both at the same t: the
    lower id wins in the culled mirror as in the plain fold; so does a tie
    between two mirrored spheres (same t, different centres)."""
    rng = np.random.default_rng(5)
    n = 40
    c = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    c[:, 2] = rng.uniform(6.0, 9.0, n)
    c[20] = c[3] = (0.0, 0.0, 4.0)
    c[33], c[12] = (0.5, 0.2, 2.5), (0.5, -0.2, 2.5)
    rad = np.full(n, 0.1, np.float32)
    rad[[3, 20]] = 0.5
    rad[[12, 33]] = 0.3
    table = torch.zeros((n, 12))
    table[:, 0:3] = torch.as_tensor(c)
    table[:, 3] = torch.as_tensor(rad)
    sph = sphere_tiles(table)
    starts = sph.starts.tolist()
    tile = [max(t for t, a in enumerate(starts[:-1]) if a <= j)
            for j in (3, 20, 12, 33)]
    assert tile[0] != tile[1] and tile[2] != tile[3]
    st = torch.zeros((24, 3))
    st[12] = 1.0
    st[3:6, 0] = torch.tensor([0.0, 0.0, 1.0])          # at 3 and 20
    st[0:3, 1] = torch.tensor([0.5, 0.0, 0.0])          # between 12 and 33
    st[3:6, 1] = torch.tensor([0.0, 0.0, 1.0])
    st[0:3, 2] = torch.tensor([0.1, 0.05, 0.0])         # 3 and 20, off axis
    st[3:6, 2] = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.0, 4.0]) - st[0:3, 2], dim=0)
    want = nearest_prim(st, table)
    got, _ = nearest_sphere_culled(st, table, sph)
    assert want.tolist() == [3, 12, 3]
    assert torch.equal(got, want)
    # each pair meets its ray at one t
    for lane, pair in ((0, (3, 20)), (1, (12, 33)), (2, (3, 20))):
        t = [nearest_hit(table[j:j + 1, 0:3], table[j:j + 1, 3],
                         st[0:3, lane:lane + 1].T, st[3:6, lane:lane + 1].T).t
             for j in pair]
        assert float(t[0]) == float(t[1]) < 1e29


def test_regen_wrapper_with_tiles_takes_plain_on_cpu():
    table, st, c13, sph, kw = _setup("rgb")
    a, b = st.clone(), st.clone()
    before = (regen_steps.launches, regen_steps.culled_launches)
    regen_steps(a, c13, table, 3, sph=sph, **kw)
    regen_steps_plain(b, c13, table, 3, **kw)
    assert torch.equal(_bits(a), _bits(b))
    assert (regen_steps.launches, regen_steps.culled_launches) == before
    with pytest.raises(ValueError):
        regen_steps(a, c13, table, 1, sph=sph,
                    stats=torch.zeros(3, dtype=torch.int64), **kw)


def test_culled_route_image_matches_jax():
    """The culled search over the route's 2 spp x 5 bounces at 32x16 on
    rtweekend: the route's image (trace_regen) is the mirror's bit for
    bit, and both follow JAX's regen_step (exact argmin, all steps in one
    launch, the permuted scene) in interpret mode within the bounds of
    test_k2_plain_matches_pallas."""
    js = jmake_scene("rtweekend")
    jp = jpermute_scene(js)
    tb = _fused_tables(jp)
    perm, _ = jtile_order(W, H)
    st0, jcam, r = _wave_init(jdefault_camera(js), jnp.asarray(perm), SPP,
                              0, 0, W, H, JBLOCK_R)
    out = np.asarray(regen_step(
        jcam, tb["t48"], tb["stab_full"], st0, use_sky=jp.use_sky,
        max_bounces=MB, width=W, height=H, exact_argmin=True,
        steps=SPP * MB))[:, :r]

    ts = make_scene("rtweekend", device="cpu")
    table, _, c13, sph, kw = _setup("rtweekend")
    st = torch.as_tensor(np.array(st0)[:, :r].copy())
    regen_steps_plain(st, torch.as_tensor(np.array(jcam)[0].copy()), table,
                      SPP * MB, sph=sph, **kw)
    color, rays = trace_regen(ts, default_camera(ts),
                              torch.as_tensor(perm), width=W, height=H,
                              spp=SPP, seed=0, max_bounces=MB)
    a, b = st.numpy(), out
    assert rays == int(a[22].sum())
    ctrl = (12, 14, 15, 22)
    for ch in ctrl:
        assert (a[ch] == b[ch]).mean() >= 0.99, ch
    assert abs(a[22].sum() - b[22].sum()) <= 0.01 * b[22].sum()
    agree = np.logical_and.reduce([a[ch] == b[ch] for ch in ctrl])
    # ten steps of FMA-contracted shading drift further than two: measured
    # at most 1.2e-4 (9.7e-4 relative) on the agreeing lanes
    np.testing.assert_allclose(a[16:19][:, agree], b[16:19][:, agree],
                               rtol=1e-3, atol=1e-4)
    # the route's own start state is JAX's but for the directions' 1e-6
    # film rounding, so its image is held to the mirror run from it
    st2, _, _ = wave_init(default_camera(ts), torch.as_tensor(perm), SPP, 0,
                          0, W, H)
    regen_steps_plain(st2, c13, table, SPP * MB, sph=sph, **kw)
    assert torch.equal(_bits(color), _bits(st2[16:19].T.contiguous()))
