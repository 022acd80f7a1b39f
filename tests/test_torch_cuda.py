"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where there is no GPU. This file imports no JAX
(the card's machine has none), so it runs there without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.kernels import build
from tpu_ray_torch.kernels.bounce_step import (
    bounce_bwd, bounce_bwd_plain, bounce_cull_mask, bounce_cull_mask_octant,
    bounce_fwd, bounce_fwd_list, bounce_fwd_list_plain, bounce_fwd_plain,
    bounce_replay, bounce_replay_plain, fused_tables, init_state,
    morton_perm, origin_bound, permute_spheres, scene_table)
from tpu_ray_torch.kernels.regen import (nearest_sphere_culled, regen_bwd,
                                         regen_bwd_info, regen_bwd_plain,
                                         regen_record, regen_steps,
                                         regen_steps_plain, regen_tables,
                                         sphere_tiles, wave_init)
from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                    sphere_nearest_hit)
from tpu_ray_torch.kernels.tri_intersect import tri_hit_plain, tri_nearest_hit
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.intersect import payload_tables
from tpu_ray_torch.ops.intersect_tri import tri_search_table
from tpu_ray_torch.ops.raygen import camera_rays

REGEN_KW = dict(use_sky=True, max_bounces=5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda_device):
    ts = make_scene("rtweekend", device=cuda_device)
    g = np.random.default_rng(0)
    o = torch.as_tensor(g.uniform(-0.8, 0.8, (1 << 14, 3)).astype(np.float32),
                        device=cuda_device)
    d = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(1 << 14, 3)).astype(np.float32), device=cuda_device),
        dim=1)
    a = sphere_nearest_hit(ts.center, ts.radius, o, d)
    b = nearest_hit_plain(ts.center, ts.radius, o, d)
    torch.cuda.synchronize()
    assert torch.equal(a.idx, b.idx) and torch.equal(a.t, b.t)


# K1's edge tables: the slots K1 skips (r * r not > 0) anywhere in the
# table, radii that hit although they are not > 0, exact ties across its
# slices and rays that start inside a sphere (the far root). Also built on
# the CPU by tests/test_torch_k1_pad.py, which holds the plain version to
# JAX's on them.
K1_CASES = ("zeros", "negative", "nan", "underflow", "padding", "single",
            "duplicates", "inside")
# the two copies of the sphere of "duplicates": near the two ends of the
# table, so in different slices of the real slots at every count past one
K1_DUP = (3, 509)


def k1_edge_table(case: str, device, n: int = 512, seed: int = 0):
    """(center [n,3], radius [n]) f32 of one of K1_CASES: a third of the
    slots real (radii 0.05-0.25, centres in [-1, 1]^3), the rest radius-0
    padding placed at random among them, then the case's change."""
    g = np.random.default_rng(seed)
    center = g.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    radius = np.zeros(n, np.float32)
    real = g.permutation(n)[:n // 3]
    radius[real] = g.uniform(0.05, 0.25, real.size)
    if case == "negative":          # hits as |r| in both packages
        radius[real[:8]] *= -1.0
    elif case == "nan":
        radius[[0, real[0], n - 1]] = np.nan
    elif case == "underflow":       # r * r rounds to 0 in f32
        radius[[1, real[1], n - 2]] = [1e-30, -1e-25, 1e-23]
    elif case == "padding":
        radius[:] = 0.0
    elif case == "single":
        radius[:] = 0.0
        radius[77] = 0.5
    elif case == "duplicates":
        radius[list(K1_DUP)] = 0.8
        center[list(K1_DUP)] = [0.1, -0.2, 0.05]
    elif case == "inside":          # every origin inside it: the far root
        radius[real[2]] = 3.0
        center[real[2]] = 0.0
    return (torch.as_tensor(center, device=device),
            torch.as_tensor(radius, device=device))


def k1_rays(r: int, device, seed: int = 1):
    """r rays: origins in [-1.2, 1.2]^3 (many inside a sphere), unit
    directions."""
    g = np.random.default_rng(seed)
    o = torch.as_tensor(g.uniform(-1.2, 1.2, (r, 3)).astype(np.float32),
                        device=device)
    d = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(r, 3)).astype(np.float32), device=device), dim=1)
    return o, d


@pytest.mark.cuda
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_edge_tables_match_plain_on_card(cuda_device, case):
    """K1 bit-equal to nearest_hit on K1_CASES' tables at ray counts 0, 1,
    37, 513 (not a multiple of a block's 512 rays) and 4,099, with the real
    slots in the slices it picks and in 1, 2, 3 and 7 slices; two launches
    bit-equal."""
    center, radius = k1_edge_table(case, cuda_device)
    o, d = k1_rays(4099, cuda_device)
    for r in (0, 1, 37, 513, 4099):
        b = nearest_hit_plain(center, radius, o[:r], d[:r])
        for slices in (None, 1, 2, 3, 7):
            a = sphere_nearest_hit(center, radius, o[:r], d[:r],
                                   slices=slices)
            a2 = sphere_nearest_hit(center, radius, o[:r], d[:r],
                                    slices=slices)
            torch.cuda.synchronize()
            assert torch.equal(a.idx, b.idx) and torch.equal(_bits(a.t),
                                                             _bits(b.t))
            assert torch.equal(a2.idx, a.idx) and torch.equal(_bits(a2.t),
                                                              _bits(a.t))
            assert not a.t.requires_grad
    hit = b.t < 1e29
    if case == "padding":
        assert not bool(hit.any()) and bool((b.idx == 0).all())
    else:
        assert bool(hit.any())
    if case == "duplicates":
        assert bool((b.idx == K1_DUP[0]).any())
        assert not bool((b.idx == K1_DUP[1]).any())
    if case == "negative":
        assert bool((radius[b.idx.long()][hit] < 0).any())


@pytest.mark.cuda
def test_k1_launch_raises_on_bad_input(cuda_device):
    """The wrapper refuses a wrong dtype or shape, a table off the card or
    a strided ray tensor, and the launch refuses a slice count out of
    range (no fallback)."""
    center, radius = k1_edge_table("zeros", cuda_device)
    o, d = k1_rays(64, cuda_device)
    with pytest.raises(ValueError):
        sphere_nearest_hit(center, radius.double(), o, d)
    with pytest.raises(ValueError):
        sphere_nearest_hit(center, radius[:-1], o, d)
    with pytest.raises(ValueError):
        sphere_nearest_hit(center.cpu(), radius, o, d)
    with pytest.raises(ValueError):
        sphere_nearest_hit(center, radius, o[::2], d[::2])
    for slices in (0, 70000):
        with pytest.raises(RuntimeError, match="trt_sphere_nearest_hit"):
            sphere_nearest_hit(center, radius, o, d, slices=slices)


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card(cuda_device):
    ts = make_scene("rtweekend", device=cuda_device)
    perm, _ = tile_order(64, 48)
    st, cam, r = wave_init(default_camera(ts),
                           torch.as_tensor(perm, device=cuda_device), 2, 0,
                           0, 64, 48)
    ref = st.clone()
    kw = dict(REGEN_KW, width=64, height=48)
    tb = payload_tables(ts)
    regen_steps(st, cam, tb, 10, **kw)
    regen_steps_plain(ref, cam, tb, 10, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st[22], ref[22])
    assert (st[16:19] - ref[16:19]).abs().max().item() < 1e-5


def _small_records(dev, seg=4):
    ts = make_scene("rtweekend", device=dev)
    tb = payload_tables(ts)
    perm, _ = tile_order(64, 48)
    st, cam, r = wave_init(default_camera(ts),
                           torch.as_tensor(perm, device=dev), 2, 0, 0, 64, 48)
    return tb, st, cam, dict(REGEN_KW, width=64, height=48)


@pytest.mark.cuda
def test_k2_record_matches_plain_on_card(cuda_device):
    tb, st, cam, kw = _small_records(cuda_device)
    a, b, c = st.clone(), st.clone(), st.clone()
    recs = regen_record(a, cam, tb, 10, 4, **kw)
    regen_steps(b, cam, tb, 10, **kw)
    _, ref = regen_steps_plain(c, cam, tb, 10, seg=4, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert torch.equal(recs.t_end, ref.t_end)
    t = torch.arange(10, device=cuda_device)[:, None]
    valid = t < ref.t_end.long()[None, :]
    assert torch.equal(recs.rec[valid], ref.rec[valid])
    for s in range(ref.chk.shape[0]):
        alive = ref.t_end.long() > s * 4
        assert torch.equal(recs.chk[s][:, alive].view(torch.int32),
                           ref.chk[s][:, alive].view(torch.int32))


@pytest.mark.cuda
def test_k3_matches_plain_on_card(cuda_device):
    tb, st, cam, kw = _small_records(cuda_device)
    recs = regen_record(st.clone(), cam, tb, 10, 4, **kw)
    g = np.random.default_rng(1)
    d_out = torch.zeros_like(st)
    d_out[16:19] = torch.as_tensor(
        g.standard_normal((3, st.shape[1])).astype(np.float32),
        device=cuda_device)
    a = regen_bwd(recs, d_out, cam, tb, **kw)
    b = regen_bwd_plain(recs, d_out, cam, tb, **kw)
    torch.cuda.synchronize()
    rows = list(range(12)) + [16, 17, 18]
    assert torch.equal(a[0][rows], b[0][rows])
    for x, y in zip(a[1:], b[1:]):
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


@pytest.mark.cuda
def test_fused_grads_match_torch_route_on_card(cuda_device):
    """render_mean through K2-record and K3 against torch.autograd of the
    eager route, on the card: each group within 3e-3 of its max."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean

    base = make_scene("rtweekend", device=cuda_device)
    grads = {}
    for backend in ("fused", "torch"):
        sc = trainable_scene(base)
        cam = trainable_camera(default_camera(base))
        img = render_mean(sc, cam, width=64, height=48, spp=2,
                          backend=backend, regen=backend == "fused")
        image_mse(img, torch.zeros_like(img)).backward()
        grads[backend] = [sc.center.grad, sc.radius.grad, sc.albedo.grad,
                          sc.emissive.grad, cam.position.grad]
    for a, b in zip(grads["fused"], grads["torch"]):
        assert (a - b).abs().max() <= 3e-3 * b.abs().max()


def _bits(t):
    return t.view(torch.int32)


def _fused_chain(dev, w=64, h=48):
    """rtweekend permuted, and the per-bounce input states of the plain
    route from a tile-ordered camera wavefront (primary bounce culled)."""
    ts = make_scene("rtweekend", device=dev)
    ts = permute_spheres(ts, morton_perm(ts))
    table = scene_table(ts)
    px = torch.as_tensor(tile_order(w, h)[0], device=dev)
    st = init_state(*camera_rays(default_camera(ts), w, h, px, 0, 0))
    states, idxs = [], []
    for b in range(5):
        states.append(st)
        mask = bounce_cull_mask(ts, st) if b == 0 else None
        st, idx = bounce_fwd_plain(st, table, b, mask, use_sky=True)
        idxs.append(idx)
    return ts, table, states, idxs


@pytest.mark.cuda
def test_k4_matches_plain_on_card(cuda_device):
    """K4 bit-equal to its plain version, unculled, with the primary mask
    and with the octant mask."""
    ts, table, states, _ = _fused_chain(cuda_device)
    for b, st in enumerate(states):
        masks = [None, bounce_cull_mask(ts, st), bounce_cull_mask_octant(
            ts, st)]
        want = bounce_fwd_plain(st, table, b, use_sky=True)
        for mask in masks:
            got = bounce_fwd(st, table, b, mask, use_sky=True)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1])
            assert torch.equal(_bits(got[0]), _bits(want[0]))


@pytest.mark.cuda
def test_k5_replays_k4_on_card(cuda_device):
    ts, table, states, _ = _fused_chain(cuda_device)
    for b, st in enumerate(states):
        out, idx = bounce_fwd(st, table, b, use_sky=True)
        rep = bounce_replay(st, table, idx, b, use_sky=True)
        want = bounce_replay_plain(st, table, idx, b, use_sky=True)
        torch.cuda.synchronize()
        assert torch.equal(_bits(rep), _bits(out))
        assert torch.equal(_bits(rep), _bits(want))


def _k4_chain(dev, w, h, name, sparse):
    """A scene's per-sample tables (with the sphere tiles) and the input
    states of 5 bounces of its route's plain K4 (the culled search, and on
    trimesh the triangle mode) from a tile-ordered camera wavefront;
    sparse: only the lanes i % 32 < 3 alive at the start, a few a warp."""
    ts = make_scene(name, device=dev)
    px = torch.as_tensor(tile_order(w, h)[0], device=dev)
    o, d, base = camera_rays(default_camera(ts), w, h, px, 0, 0)
    tb = fused_tables(ts, origin_bound(o))
    st = init_state(o, d, base)
    if sparse:
        st[12] = (torch.arange(w * h, device=dev) % 32 < 3).float()
    states = []
    for b in range(5):
        states.append(st)
        st, _ = bounce_fwd_plain(st, tb.table, b, use_sky=True, tri=tb.tri,
                                 n_sph=tb.n_sph, sph=tb.sph)
    return tb, states


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,sparse", [(64, 48, False), (100, 37, True)])
def test_k4_culled_matches_plain_on_card(cuda_device, w, h, sparse):
    """K4's culled sphere search on rtweekend, on all lanes, bit-equal to
    its plain version and to the kernel's fold over every sphere, its
    counters the plain mirror's; at 100x37 the last block is ragged and a
    few lanes a warp are alive (the warp shares their tiles' folds)."""
    tb, states = _k4_chain(cuda_device, w, h, "rtweekend", sparse)
    for b, st in enumerate(states):
        stats = torch.zeros(3, dtype=torch.int64, device=cuda_device)
        mirror = torch.zeros_like(stats)
        n0 = (bounce_fwd.culled_launches, bounce_fwd.tri_launches)
        got = bounce_fwd(st, tb.table, b, use_sky=True, sph=tb.sph,
                         stats=stats)
        full = bounce_fwd(st, tb.table, b, use_sky=True)
        want = bounce_fwd_plain(st, tb.table, b, use_sky=True, sph=tb.sph,
                                stats=mirror)
        torch.cuda.synchronize()
        assert (bounce_fwd.culled_launches - n0[0],
                bounce_fwd.tri_launches - n0[1]) == (1, 0)
        for x in (got, full):
            assert torch.equal(x[1], want[1])
            assert torch.equal(_bits(x[0]), _bits(want[0]))
        assert torch.equal(stats, mirror)
        alive = int((st[12] > 0.5).sum())
        assert 0 < stats[2] < alive * tb.table.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,sparse", [(64, 48, False), (100, 37, True)])
def test_k4_tri_mode_matches_plain_on_card(cuda_device, w, h, sparse):
    """K4's triangle mode on trimesh, on all lanes, with the spheres
    culled and whole, bit-equal to its plain version (winners, triangle
    ones among them, and state), counted as triangle launches, and equal
    to K8's plain version (the block lists) on these states."""
    tb, states = _k4_chain(cuda_device, w, h, "trimesh", sparse)
    kw = dict(use_sky=True, tri=tb.tri, n_sph=tb.n_sph)
    wins = []
    for b, st in enumerate(states):
        n0 = bounce_fwd.tri_launches
        got = bounce_fwd(st, tb.table, b, sph=tb.sph, **kw)
        whole = bounce_fwd(st, tb.table, b, **kw)
        want = bounce_fwd_plain(st, tb.table, b, sph=tb.sph, **kw)
        listed = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, b,
                                       n_sph=tb.n_sph, use_sky=True)
        torch.cuda.synchronize()
        assert bounce_fwd.tri_launches - n0 == 2
        for x in (got, whole, listed):
            assert torch.equal(x[1], want[1])
            assert torch.equal(_bits(x[0]), _bits(want[0]))
        wins.append(want[1])
    assert (torch.stack(wins) >= tb.n_sph).any()


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,sparse", [(64, 48, False), (100, 37, True)])
def test_k8_ordered_fold_matches_plain_on_card(cuda_device, w, h, sparse):
    """K8's front-to-back fold on trimesh bit-equal to its plain version
    (the ascending fold of the block's listed tiles), on all lanes, at
    64x48 and at a ragged 100x37 with a few lanes a warp alive; its
    counters count listed tiles, live blocks and tested pairs within
    their bounds."""
    tb, states = _k4_chain(cuda_device, w, h, "trimesh", sparse)
    kw = dict(n_sph=tb.n_sph, use_sky=True)
    n_blocks, n_tiles = -(-w * h // 256), tb.boxes.shape[0]
    for b, st in enumerate(states):
        stats = torch.zeros(3, dtype=torch.int64, device=cuda_device)
        out, idx = bounce_fwd_list(st, tb.table, tb.tri, tb.boxes, b,
                                   stats=stats, **kw)
        want, want_idx = bounce_fwd_list_plain(st, tb.table, tb.tri,
                                               tb.boxes, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(idx, want_idx)
        assert torch.equal(_bits(out), _bits(want))
        listed, live, pairs = stats.tolist()
        alive = int((st[12] > 0.5).sum())
        assert live <= n_blocks and listed <= live * n_tiles
        assert pairs <= alive * n_tiles * 128
        assert (alive > 0) == (live > 0)


def _check_k6(dev, w, h):
    """K6 over the chain's states with random cotangents: d_state equal to
    the plain version's, d_table within 1e-4 of each group's max of the
    plain f64 sum, and two launches bit-equal."""
    ts, table, states, idxs = _fused_chain(dev, w, h)
    g = np.random.default_rng(2)
    for b, st in enumerate(states):
        d_out = torch.as_tensor(g.standard_normal(st.shape).astype(
            np.float32), device=dev)
        d_out[12:16] = 0.0
        a = bounce_bwd(st, table, idxs[b], b, d_out.clone(), use_sky=True)
        a2 = bounce_bwd(st, table, idxs[b], b, d_out.clone(), use_sky=True)
        p = bounce_bwd_plain(st, table, idxs[b], b, d_out.clone(),
                             use_sky=True)
        torch.cuda.synchronize()
        assert torch.equal(a[0], p[0])
        assert torch.equal(_bits(a[0]), _bits(a2[0]))
        assert torch.equal(_bits(a[1]), _bits(a2[1]))
        for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                     slice(10, 11), slice(11, 12)):
            want = p[1][:, cols]
            err = (a[1][:, cols] - want).abs().max().item()
            assert err <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_k6_matches_plain_on_card(cuda_device):
    """K6 against its plain version, one lane tile a block."""
    _check_k6(cuda_device, 64, 48)


@pytest.mark.cuda
def test_k6_multi_tile_matches_plain_on_card(cuda_device):
    """K6 against its plain version where each block sums several lane
    tiles into its partials: 650x350 = 227,500 lanes, 889 tiles of 256
    (the last ragged) over the 256 blocks of the first launch."""
    assert build.load().trt_bounce_bwd_parts(650 * 350, 512) == 256
    _check_k6(cuda_device, 650, 350)


@pytest.mark.cuda
def test_fused_no_regen_grads_match_torch_route_on_card(cuda_device):
    """render_mean through K4/K5/K6 against torch.autograd of the eager
    route, on the card: the same image and each group within 3e-3 of its
    max."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean

    base = make_scene("rtweekend", device=cuda_device)
    grads, imgs = {}, {}
    for backend in ("fused", "torch"):
        sc = trainable_scene(base)
        cam = trainable_camera(default_camera(base))
        img = render_mean(sc, cam, width=64, height=48, spp=2,
                          backend=backend, regen=False)
        image_mse(img, torch.zeros_like(img)).backward()
        imgs[backend] = img.detach()
        grads[backend] = [sc.center.grad, sc.radius.grad, sc.albedo.grad,
                          sc.emissive.grad, cam.position.grad]
    assert torch.equal(imgs["fused"], imgs["torch"])
    for a, b in zip(grads["fused"], grads["torch"]):
        assert (a - b).abs().max() <= 3e-3 * b.abs().max()


# ---------------------------------------------------------------------------
# triangle scenes: K7, K2's triangle mode, K3's triangle branch
# ---------------------------------------------------------------------------

def _tri_records(dev, w=64, h=48, name="trimesh", seg=4):
    """The regen route's tables of the permuted scene, its recorded trace
    at w x h, 2 spp, and a random colour cotangent."""
    ts = make_scene(name, device=dev)
    table, tri, n_tri = regen_tables(ts)
    perm, _ = tile_order(w, h)
    st, cam, _ = wave_init(default_camera(ts),
                           torch.as_tensor(perm, device=dev), 2, 0, 0, w, h)
    kw = dict(REGEN_KW, width=w, height=h)
    recs = regen_record(st.clone(), cam, table, 10, seg, tri=tri, **kw)
    d_out = torch.zeros_like(st)
    d_out[16:19] = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, st.shape[1])).astype(np.float32), device=dev)
    return table, tri, n_tri, st, cam, kw, recs, d_out


@pytest.mark.cuda
def test_k7_matches_plain_on_card(cuda_device):
    """K7 bit-equal to nearest_hit_tri on trimesh's primary rays and on
    random rays from inside the scene."""
    ts = make_scene("trimesh", device=cuda_device)
    px = torch.arange(64 * 48, device=cuda_device)
    o, d, _ = camera_rays(default_camera(ts), 64, 48, px, 0, 0)
    g = np.random.default_rng(4)
    o2 = torch.as_tensor(g.uniform(-0.2, 0.2, (4096, 3)).astype(np.float32),
                         device=cuda_device)
    d2 = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(4096, 3)).astype(np.float32), device=cuda_device),
        dim=1)
    tab = tri_search_table(ts.tris)
    for oo, dd in ((o, d), (o2, d2)):
        a = tri_nearest_hit(tab, oo, dd)
        b = tri_hit_plain(tab, oo, dd)
        torch.cuda.synchronize()
        assert torch.equal(a.idx, b.idx) and torch.equal(_bits(a.t),
                                                         _bits(b.t))
        assert (a.t < 1e29).any()


def _k7_rays(dev, n, seed):
    """n random rays from inside trimesh's extent, unit directions."""
    g = np.random.default_rng(seed)
    o = torch.as_tensor(g.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
                        device=dev)
    d = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(n, 3)).astype(np.float32), device=dev), dim=1)
    return o, d


def _k7_check(tab, o, d, slices):
    a = tri_nearest_hit(tab, o, d, slices=slices)
    b = tri_hit_plain(tab, o, d)
    torch.cuda.synchronize()
    assert torch.equal(a.idx, b.idx) and torch.equal(_bits(a.t), _bits(b.t))
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 37, 57600])
def test_k7_slices_match_plain_on_card(cuda_device, r):
    """K7 bit-equal to nearest_hit_tri on trimesh at ragged ray counts,
    with the triangle axis in the slices it picks, in one slice and in
    several (each merged by its 64-bit (t, id) key)."""
    from tpu_ray_torch.kernels.tri_intersect import tri_slices
    ts = make_scene("trimesh", device=cuda_device)
    tab = tri_search_table(ts.tris)
    o, d = _k7_rays(cuda_device, r, r)
    picked = tri_slices(r, tab.shape[0], cuda_device)
    assert picked > 1          # these counts do not fill the card alone
    for slices in (None, 1, 3, 81):
        hit = _k7_check(tab, o, d, slices)
    assert r == 1 or (hit.t < 1e29).any()


@pytest.mark.cuda
def test_k7_single_slice_threshold_on_card(cuda_device):
    """At the smallest ray count that K7 sweeps in one slice, and one ray
    fewer (split again), bit-equal to the plain version, in the slices it
    picks and forced to one and to four; 512 of trimesh's triangles keep
    the plain sweep short."""
    from tpu_ray_torch.kernels.tri_intersect import tri_slices
    ts = make_scene("trimesh", device=cuda_device)
    tab = tri_search_table(ts.tris)[:512].contiguous()
    m = tab.shape[0]
    lo, hi = 1, 1 << 24        # tri_slices(lo) > 1 == tri_slices(hi)
    assert tri_slices(lo, m, cuda_device) > 1
    assert tri_slices(hi, m, cuda_device) == 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if tri_slices(mid, m, cuda_device) == 1:
            hi = mid
        else:
            lo = mid
    o, d = _k7_rays(cuda_device, hi, 5)
    assert tri_slices(hi - 1, m, cuda_device) == 2
    for r in (hi - 1, hi):
        for slices in (None, 1, 4):
            _k7_check(tab, o[:r], d[:r], slices)


@pytest.mark.cuda
def test_k7_exact_tie_and_misses_across_slices_on_card(cuda_device):
    """A triangle (id 5) and its copy in another slice (id 700) at the same
    t: the lower id wins in any slice count; rays that meet nothing miss
    (t = 1e30, idx 0) as the plain version does."""
    tab = torch.zeros((1024, 9), device=cuda_device)
    big = torch.tensor([-10.0, -10.0, 5.0, 40.0, 0.0, 0.0, 0.0, 40.0, 0.0],
                       device=cuda_device)
    tab[5] = big
    tab[700] = big
    g = np.random.default_rng(7)
    o = torch.as_tensor(np.c_[g.uniform(-1, 1, (3000, 2)),
                              np.zeros(3000)].astype(np.float32),
                        device=cuda_device)
    z = np.where(np.arange(3000) % 3 == 0, -1.0, 1.0)[:, None]
    d = torch.nn.functional.normalize(torch.as_tensor(np.c_[
        g.uniform(-0.05, 0.05, (3000, 2)), z].astype(np.float32),
        device=cuda_device), dim=1)
    up = d[:, 2] > 0
    for slices in (None, 1, 2, 4, 7):
        hit = _k7_check(tab, o, d, slices)
        assert bool((hit.idx[up] == 5).all())
        assert bool((hit.t[~up] == 1e30).all() and (hit.idx[~up] == 0).all())


@pytest.mark.cuda
def test_k2_triangle_mode_matches_plain_on_card(cuda_device):
    """K2 over trimesh, forward-only and recording, bit-equal to
    regen_steps_plain (state, records, checkpoints)."""
    table, tri, _, st, cam, kw, recs, _ = _tri_records(cuda_device)
    a, c = st.clone(), st.clone()
    regen_steps(a, cam, table, 10, tri=tri, **kw)
    _, ref = regen_steps_plain(c, cam, table, 10, seg=4, tri=tri, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(c))
    assert torch.equal(recs.t_end, ref.t_end)
    valid = torch.arange(10, device=cuda_device)[:, None] < \
        ref.t_end.long()[None, :]
    assert torch.equal(recs.rec[valid], ref.rec[valid])
    assert (recs.rec[valid] >= table.shape[0] - tri.shape[0]).any()
    for s in range(ref.chk.shape[0]):
        alive = ref.t_end.long() > s * 4
        assert torch.equal(_bits(recs.chk[s][:, alive]),
                           _bits(ref.chk[s][:, alive]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trimesh", "rtweekend"])
def test_k3_matches_plain_and_repeats_on_card(cuda_device, name):
    """K3 on the regen route's permuted tables: d_state equal to plain,
    d_table and d_cam within 1e-4 of each group's max of the plain f64
    sum, and two launches bit-equal."""
    table, _, n_tri, _, cam, kw, recs, d_out = _tri_records(cuda_device,
                                                            name=name)
    a = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
    a2 = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
    b = regen_bwd_plain(recs, d_out, cam, table, n_tri=n_tri, **kw)
    torch.cuda.synchronize()
    rows = list(range(12)) + [16, 17, 18]
    assert torch.equal(a[0][rows], b[0][rows])
    for x, x2 in zip(a, a2):
        assert torch.equal(_bits(x), _bits(x2))
    for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                 slice(10, 11), slice(11, 12)):
        want = b[1][:, cols]
        assert (a[1][:, cols] - want).abs().max() <= \
            1e-4 * want.abs().max()
    for k in range(0, 12, 3):
        want = b[2][k:k + 3]
        assert (a[2][k:k + 3] - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_k3_multi_tile_repeats_on_card(cuda_device):
    """Two K3 launches bit-equal where each block sums several lane tiles
    (650x350 = 227,500 lanes: over 1,024 blocks of two warps on
    rtweekend, the partial row in shared memory, and 256 blocks of 256
    threads on trimesh, in global memory)."""
    lib = build.load()
    assert lib.trt_regen_bwd_parts(650 * 350, 512) == 1024
    assert lib.trt_regen_bwd_parts(650 * 350, 10496) == 256
    for name in ("rtweekend", "trimesh"):
        table, _, n_tri, _, cam, kw, recs, d_out = _tri_records(
            cuda_device, 650, 350, name)
        a = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
        a2 = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
        torch.cuda.synchronize()
        for x, x2 in zip(a, a2):
            assert torch.equal(_bits(x), _bits(x2))
        assert a[1].abs().max() > 0


def _culled_setup(dev, w=160, h=96):
    """rtweekend's permuted table, its sphere tiles and the route's state at
    w x h, 2 spp."""
    ts = make_scene("rtweekend", device=dev)
    table, _, _ = regen_tables(ts)
    cam = default_camera(ts)
    perm, _ = tile_order(w, h)
    st, c13, _ = wave_init(cam, torch.as_tensor(perm, device=dev), 2, 0, 0,
                           w, h)
    sph = sphere_tiles(table, float(cam.position.abs().max()))
    return table, st, c13, sph, dict(REGEN_KW, width=w, height=h)


@pytest.mark.cuda
def test_k2_culled_matches_plain_on_card(cuda_device):
    """K2's culled sphere search, forward and recording, bit-equal to the
    plain version that folds every sphere (state, records, checkpoints),
    with the plain mirror's counts."""
    table, st, c13, sph, kw = _culled_setup(cuda_device)
    a, b, c, m = st.clone(), st.clone(), st.clone(), st.clone()
    stats = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    regen_steps(a, c13, table, 10, sph=sph, stats=stats, **kw)
    recs = regen_record(b, c13, table, 10, 4, sph=sph, **kw)
    _, ref = regen_steps_plain(c, c13, table, 10, seg=4, **kw)
    mirror = torch.zeros_like(stats)
    regen_steps_plain(m, c13, table, 10, sph=sph, stats=mirror, **kw)
    torch.cuda.synchronize()
    for x in (a, b, m):
        assert torch.equal(_bits(x), _bits(c))
    assert torch.equal(stats, mirror)
    assert stats[2] < int(c[22].sum()) * table.shape[0] // 4
    assert torch.equal(recs.t_end, ref.t_end)
    t = torch.arange(10, device=cuda_device)[:, None]
    valid = t < ref.t_end.long()[None, :]
    assert torch.equal(recs.rec[valid], ref.rec[valid])
    for s in range(ref.chk.shape[0]):
        alive = ref.t_end.long() > s * 4
        assert torch.equal(_bits(recs.chk[s][:, alive]),
                           _bits(ref.chk[s][:, alive]))


@pytest.mark.cuda
def test_k2_culled_exact_tie_on_card(cuda_device):
    """Spheres 3 and 20 share a centre and radius in different tiles, 12
    and 33 mirror each other about a ray: the lower id wins on the card as
    in the plain fold, in a warp whose 32 live lanes fold the tied tiles
    each on its own and in one whose 5 live lanes fold them together
    (common.cuh TRT_SPH_SHARE_LANES, 6)."""
    n = 40
    g = np.random.default_rng(5)
    c = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    c[:, 2] = g.uniform(6.0, 9.0, n)
    c[20] = c[3] = (0.0, 0.0, 4.0)
    c[33], c[12] = (0.5, 0.2, 2.5), (0.5, -0.2, 2.5)
    rad = np.full(n, 0.1, np.float32)
    rad[[3, 20]] = 0.5
    rad[[12, 33]] = 0.3
    table = torch.zeros((n, 12), device=cuda_device)
    table[:, 0:3] = torch.as_tensor(c, device=cuda_device)
    table[:, 3] = torch.as_tensor(rad, device=cuda_device)
    table[:, 4:7] = 0.5
    sph = sphere_tiles(table)
    r = 64                                  # two warps, lanes of each kind
    live = torch.arange(r, device=cuda_device) < 37
    st = torch.zeros((24, r), device=cuda_device)
    st[12] = live.float()
    st[6:9] = 1.0
    o = torch.zeros((3, r), device=cuda_device)
    o[0, 1::3] = 0.5
    o[0:2, 2::3] = torch.tensor([[0.1], [0.05]], device=cuda_device)
    d = torch.tensor([0.0, 0.0, 4.0], device=cuda_device)[:, None] - o
    d[:, 1::3] = torch.tensor([[0.0], [0.0], [1.0]], device=cuda_device)
    st[0:3] = o
    st[3:6] = torch.nn.functional.normalize(d, dim=0)
    cam = torch.zeros(13, device=cuda_device)
    cam[12] = 1.0
    kw = dict(REGEN_KW, width=8, height=8)
    recs = regen_record(st.clone(), cam, table, 1, 1, sph=sph, **kw)
    _, ref = regen_steps_plain(st.clone(), cam, table, 1, seg=1, **kw)
    want, _ = nearest_sphere_culled(st, table, sph)
    # K4's culled search, the same fold, on the per-sample state
    s16 = st[:16].contiguous()
    k4, k4_idx = bounce_fwd(s16, table, 0, use_sky=True, sph=sph)
    p4, p4_idx = bounce_fwd_plain(s16, table, 0, use_sky=True, sph=sph)
    torch.cuda.synchronize()
    assert torch.equal(recs.t_end, live.int())
    assert torch.equal(recs.rec[0][live], ref.rec[0][live])
    assert torch.equal(recs.rec[0][live].long(), want[live])
    assert set(want[live].tolist()) == {3, 12}
    assert torch.equal(k4_idx, p4_idx)
    assert torch.equal(k4_idx[live].long(), want[live])
    assert torch.equal(_bits(k4), _bits(p4))


@pytest.mark.cuda
def test_k3_shared_row_on_card(cuda_device):
    """K3 in blocks of two warps, the partial row in shared memory, more
    than 8 warps an SM, on rtweekend's permuted table at 650x350 (several
    lane tiles a block): two launches bit-equal, d_state equal to plain,
    d_table within 1e-4 of each column's max."""
    table, _, _, st, cam, kw, recs, d_out = _tri_records(
        cuda_device, 650, 350, "rtweekend")
    a = regen_bwd(recs, d_out, cam, table, **kw)
    a2 = regen_bwd(recs, d_out, cam, table, **kw)
    info = regen_bwd_info(table.shape[0], cuda_device)
    b = regen_bwd_plain(recs, d_out, cam, table, **kw)
    torch.cuda.synchronize()
    assert info["threads"] == 64 and info["warps_per_sm"] > 8
    for x, x2 in zip(a, a2):
        assert torch.equal(_bits(x), _bits(x2))
    rows = list(range(12)) + [16, 17, 18]
    assert torch.equal(a[0][rows], b[0][rows])
    for k in range(12):
        want = b[1][:, k]
        assert (a[1][:, k] - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_k3_row_past_shared_memory_on_card(cuda_device):
    """A sphere table whose [n, 12] partial row is too large for shared
    memory (rtweekend padded to 2,304 rows, 110.6 KB) takes the global-row
    branch: two launches bit-equal and against plain."""
    ts = make_scene("rtweekend", pad_to=2304, device=cuda_device)
    table, _, _ = regen_tables(ts)
    assert 12 * 4 * table.shape[0] > 96 * 1024
    perm, _ = tile_order(96, 64)
    st, cam, _ = wave_init(default_camera(ts),
                           torch.as_tensor(perm, device=cuda_device), 2, 0,
                           0, 96, 64)
    kw = dict(REGEN_KW, width=96, height=64)
    recs = regen_record(st.clone(), cam, table, 10, 4, **kw)
    d_out = torch.zeros_like(st)
    d_out[16:19] = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, st.shape[1])).astype(np.float32), device=cuda_device)
    a = regen_bwd(recs, d_out, cam, table, **kw)
    a2 = regen_bwd(recs, d_out, cam, table, **kw)
    b = regen_bwd_plain(recs, d_out, cam, table, **kw)
    torch.cuda.synchronize()
    assert regen_bwd_info(table.shape[0], cuda_device)["threads"] == 256
    for x, x2 in zip(a, a2):
        assert torch.equal(_bits(x), _bits(x2))
    rows = list(range(12)) + [16, 17, 18]
    assert torch.equal(a[0][rows], b[0][rows])
    for k in range(12):
        want = b[1][:, k]
        assert (a[1][:, k] - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_triangle_routes_on_card(cuda_device):
    """trimesh on the card: backend cuda (K1 + K7) renders backend
    torch's image bit for bit; fused+regen gradients against backend cuda
    autograd within 3e-3 of each group's max, triangle leaves included."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.models.path_tracer import render_pass

    base = make_scene("trimesh", device=cuda_device)
    cam0 = default_camera(base)
    before = tri_nearest_hit.launches
    a, ra = render_pass(base, cam0, width=64, height=48, spp=2,
                        backend="cuda")
    assert tri_nearest_hit.launches > before
    b, rb = render_pass(base, cam0, width=64, height=48, spp=2,
                        backend="torch")
    assert ra == rb and torch.equal(a, b)
    grads = {}
    for backend in ("fused", "cuda"):
        sc = trainable_scene(base)
        cam = trainable_camera(cam0)
        img = render_mean(sc, cam, width=64, height=48, spp=2,
                          backend=backend, regen=backend == "fused")
        image_mse(img, torch.zeros_like(img)).backward()
        grads[backend] = [sc.leaf(k).grad for k in sc.leaves] + [
            cam.position.grad]
    for a, b in zip(grads["fused"], grads["cuda"]):
        assert (a - b).abs().max() <= 3e-3 * b.abs().max().clamp_min(1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(64, 48), (100, 37)])
def test_k2_listed_mode_matches_plain_on_card(cuda_device, w, h):
    """K2's listed mode over trimesh (2 spp, all 10 steps), forward-only
    and recording, bit-equal to regen_steps_plain with the tile boxes
    (state, records, checkpoints, t_end), with a ragged last block at
    100x37; its counters count listed tiles and tested pairs within their
    bounds, and the launches are counted as listed."""
    from tpu_ray_torch.kernels.bounce_step import tab_tile_boxes
    ts = make_scene("trimesh", device=cuda_device)
    table, tri, _ = regen_tables(ts)
    boxes = tab_tile_boxes(tri)
    perm, _ = tile_order(w, h)
    st, cam, _ = wave_init(default_camera(ts),
                           torch.as_tensor(perm, device=cuda_device), 2, 0,
                           0, w, h)
    kw = dict(REGEN_KW, width=w, height=h)
    a, b, c = st.clone(), st.clone(), st.clone()
    stats = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    n0 = (regen_steps.listed_launches, regen_record.listed_launches)
    regen_steps(a, cam, table, 10, tri=tri, boxes=boxes, stats=stats, **kw)
    recs = regen_record(b, cam, table, 10, 4, tri=tri, boxes=boxes, **kw)
    _, ref = regen_steps_plain(c, cam, table, 10, seg=4, tri=tri,
                               boxes=boxes, **kw)
    torch.cuda.synchronize()
    assert (regen_steps.listed_launches - n0[0],
            regen_record.listed_launches - n0[1]) == (1, 1)
    assert torch.equal(_bits(a), _bits(c)) and torch.equal(_bits(b),
                                                           _bits(c))
    assert torch.equal(recs.t_end, ref.t_end)
    valid = torch.arange(10, device=cuda_device)[:, None] < \
        ref.t_end.long()[None, :]
    assert torch.equal(recs.rec[valid], ref.rec[valid])
    assert (recs.rec[valid] >= table.shape[0] - tri.shape[0]).any()
    for s in range(ref.chk.shape[0]):
        alive = ref.t_end.long() > s * 4
        assert torch.equal(_bits(recs.chk[s][:, alive]),
                           _bits(ref.chk[s][:, alive]))
    listed, live, pairs = stats.tolist()
    n_blocks, n_tiles = -(-st.shape[1] // 256), boxes.shape[0]
    assert 0 < live <= 10 * n_blocks and 0 < listed <= live * n_tiles
    assert 0 < pairs <= int(c[22].sum()) * n_tiles * 128


def _tie_soup(dev):
    """Two tiles of 128 triangles, the rest degenerate: tile 0 holds the
    triangle z = 5 (-10..30 in x and y) at id 5, tile 1 the same
    triangle at id 130 and, at id 131, a small one at z = 1 off to the
    side, so tile 1's box starts nearer the rays than tile 0's. Rays from
    near the origin along +z meet both copies at the same t."""
    tab = torch.zeros((256, 9), device=dev)
    big = torch.tensor([-10.0, -10.0, 5.0, 40.0, 0.0, 0.0, 0.0, 40.0, 0.0],
                       device=dev)
    tab[5] = big
    tab[130] = big
    tab[131] = torch.tensor([50.0, 50.0, 1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                            device=dev)
    g = np.random.default_rng(6)
    o = torch.as_tensor(np.c_[g.uniform(-1, 1, (512, 2)),
                              np.zeros(512)].astype(np.float32), device=dev)
    d = torch.nn.functional.normalize(torch.as_tensor(np.c_[
        g.uniform(-0.05, 0.05, (512, 2)), np.ones(512)].astype(np.float32),
        device=dev), dim=1)
    return tab, o, d


@pytest.mark.cuda
def test_exact_tie_across_tiles_on_card(cuda_device):
    """An exact tie in t between two tiles, where the front-to-back order
    folds the higher id's tile first: K10, K2's listed mode, K8, K4's
    triangle mode (its spheres culled) and K9 keep the lowest id, as their
    plain versions do, with every lane alive (each lane folds the tile
    itself) and with 4 lanes a warp (the warp shares each lane's fold)."""
    import dataclasses

    from tpu_ray_torch.core.scene import SceneBuilder
    from tpu_ray_torch.core.trimesh import Triangles
    from tpu_ray_torch.kernels.bounce_step import prim_table, tab_tile_boxes
    from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit_stream,
                                                     tri_stream_plain)
    tab, o, d = _tie_soup(cuda_device)
    boxes = tab_tile_boxes(tab)
    sparse = torch.arange(512, device=cuda_device) % 8 == 0
    for al in (None, sparse):
        k = tri_nearest_hit_stream(tab, boxes, o, d, al)
        p = tri_stream_plain(tab, boxes, o, d, al)
        torch.cuda.synchronize()
        live = slice(None) if al is None else al
        assert bool((p.idx[live] == 5).all())
        assert torch.equal(k.idx, p.idx) and torch.equal(_bits(k.t),
                                                         _bits(p.t))

    sb = SceneBuilder()
    sb.add((0.0, 100.0, 0.0), 1.0, (0.5, 0.5, 0.5), world_scale=False)
    base = sb.build(look_at=(0.0, 0.0, 5.0), use_sky=True,
                    default_distance=6.0, default_x_angle=0.0,
                    default_y_height=0.0, device=cuda_device)
    z = torch.zeros_like(tab[:, 0:3])
    tris = Triangles(v0=tab[:, 0:3], e1=tab[:, 3:6], e2=tab[:, 6:9],
                     albedo=z + 0.5, emissive=z, specular=z[:, 0],
                     ior=z[:, 0], n_real=3)
    table = prim_table(dataclasses.replace(base, tris=tris))
    n_sph = table.shape[0] - 256
    sph = sphere_tiles(table[:n_sph])
    st = torch.zeros((24, 512), device=cuda_device)
    st[0:3], st[3:6] = o.T, d.T
    st[6:9] = 1.0
    st[12] = 1.0
    cam = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0,
                        1.0, 0.0, 1.0], device=cuda_device)
    kw = dict(REGEN_KW, width=32, height=16)
    for alive in (st[12], sparse.float()):
        st[12] = alive
        a, c = st.clone(), st.clone()
        recs = regen_record(a, cam, table, 1, 1, tri=tab, boxes=boxes, **kw)
        _, ref = regen_steps_plain(c, cam, table, 1, seg=1, tri=tab,
                                   boxes=boxes, **kw)
        torch.cuda.synchronize()
        on = alive > 0.5
        assert bool((ref.rec[0][on] == n_sph + 5).all())
        assert torch.equal(recs.t_end, ref.t_end)
        assert torch.equal(recs.rec[:, on], ref.rec[:, on])
        assert torch.equal(_bits(a), _bits(c))
        # the per-sample route's kernels on the same rays
        s16 = st[:16].contiguous()
        bkw = dict(n_sph=n_sph, use_sky=True)
        runs = [(bounce_fwd_list(s16, table, tab, boxes, 0, **bkw),
                 bounce_fwd_list_plain(s16, table, tab, boxes, 0, **bkw)),
                (bounce_fwd(s16, table, 0, tri=tab, sph=sph, **bkw),
                 bounce_fwd_plain(s16, table, 0, tri=tab, sph=sph, **bkw))]
        torch.cuda.synchronize()
        for (out_k, idx_k), (out_p, idx_p) in runs:
            assert bool((idx_p[on] == n_sph + 5).all())
            assert torch.equal(idx_k, idx_p)
            assert torch.equal(_bits(out_k), _bits(out_p))

    # K9, flat, on the camera's rays (all meet both copies at one t): the
    # copy at id 130 is brighter, so the winner shows in the colour; all
    # 512 lanes of a block, and 4
    from tpu_ray_torch.kernels.simple_shade import (lane_rows, simple_trace,
                                                    simple_trace_plain)
    alb = z + 0.5
    alb[130] = 0.9
    table9 = prim_table(dataclasses.replace(
        base, tris=dataclasses.replace(tris, albedo=alb)))
    rows = lane_rows(torch.arange(512, device=cuda_device), 32, 0)
    kw9 = dict(n_sph=n_sph, spp=1, s0=0, width=32, height=16, use_sky=True,
               flat=True, sph=sphere_tiles(table9[:n_sph]))
    for lanes in (512, 4):
        args = (rows[:, :lanes].contiguous(), cam, table9, tab, boxes, None,
                None)
        got = simple_trace(*args, **kw9)
        want = simple_trace_plain(*args, **kw9)
        torch.cuda.synchronize()
        assert bool((want[0:3] == 0.5).all())
        assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the per-sample route on triangle scenes: K8, K5's and K6's triangle modes
# ---------------------------------------------------------------------------

def _tri_fused_chain(dev, w=64, h=48):
    """trimesh's per-sample tables, and the per-bounce input states and
    winners of the plain route from a tile-ordered camera wavefront."""
    ts = make_scene("trimesh", device=dev)
    tb = fused_tables(ts, origin_bound(default_camera(ts).position[None]))
    px = torch.as_tensor(tile_order(w, h)[0], device=dev)
    st = init_state(*camera_rays(default_camera(ts), w, h, px, 0, 0))
    states, idxs = [], []
    for b in range(5):
        states.append(st)
        st, idx = bounce_fwd_list_plain(st, tb.table, tb.tri, tb.boxes, b,
                                        n_sph=tb.n_sph, use_sky=True)
        idxs.append(idx)
    return tb, states, idxs


@pytest.mark.cuda
def test_k8_and_k5_tri_match_plain_on_card(cuda_device):
    """K8 bit-equal to its plain version (state and winners, triangle
    winners among them), and K5's triangle mode replaying K8 bit for bit
    and equal to its own plain version."""
    tb, states, idxs = _tri_fused_chain(cuda_device)
    kw = dict(n_sph=tb.n_sph, use_sky=True)
    for b, st in enumerate(states):
        out, idx = bounce_fwd_list(st, tb.table, tb.tri, tb.boxes, b, **kw)
        want, want_idx = bounce_fwd_list_plain(st, tb.table, tb.tri,
                                               tb.boxes, b, **kw)
        rep = bounce_replay(st, tb.table, idx, b, **kw)
        rep_p = bounce_replay_plain(st, tb.table, idx, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(idx, want_idx) and torch.equal(idx, idxs[b])
        assert torch.equal(_bits(out), _bits(want))
        assert torch.equal(_bits(rep), _bits(out))
        assert torch.equal(_bits(rep_p), _bits(out))
    assert (torch.stack(idxs) >= tb.n_sph).any()


def _check_k6_tri(dev, w, h):
    """K6's triangle mode over the chain's states with random cotangents:
    d_state equal to the plain version's, d_table within 1e-4 of each
    group's max of the plain f64 sum (sphere and triangle rows apart),
    two launches bit-equal at trimesh's P = 10,496."""
    tb, states, idxs = _tri_fused_chain(dev, w, h)
    assert tb.table.shape[0] == 10496
    kw = dict(n_sph=tb.n_sph, use_sky=True)
    g = np.random.default_rng(5)
    for b, st in enumerate(states):
        d_out = torch.as_tensor(g.standard_normal(st.shape).astype(
            np.float32), device=dev)
        d_out[12:16] = 0.0
        a = bounce_bwd(st, tb.table, idxs[b], b, d_out.clone(), **kw)
        a2 = bounce_bwd(st, tb.table, idxs[b], b, d_out.clone(), **kw)
        p = bounce_bwd_plain(st, tb.table, idxs[b], b, d_out.clone(), **kw)
        torch.cuda.synchronize()
        assert torch.equal(a[0], p[0])
        assert torch.equal(_bits(a[0]), _bits(a2[0]))
        assert torch.equal(_bits(a[1]), _bits(a2[1]))
        for rows in (slice(0, tb.n_sph), slice(tb.n_sph, None)):
            for cols in (slice(0, 3), slice(3, 4), slice(4, 7),
                         slice(7, 10), slice(10, 11), slice(11, 12)):
                want = p[1][rows, cols]
                err = (a[1][rows, cols] - want).abs().max().item()
                assert err <= 1e-4 * want.abs().max().item()
        assert p[1][tb.n_sph:, 0:4].abs().max() > 0


@pytest.mark.cuda
def test_k6_tri_matches_plain_on_card(cuda_device):
    """One lane tile a block (the accumulator rows in global memory)."""
    _check_k6_tri(cuda_device, 64, 48)


@pytest.mark.cuda
def test_k6_tri_multi_tile_matches_plain_on_card(cuda_device):
    """Several lane tiles a block: 650x350 = 227,500 lanes over the 256
    blocks of the first launch."""
    _check_k6_tri(cuda_device, 650, 350)


def _merge_ids(pattern, r, threads, n_sph, m, g):
    """Synthetic winners over r lanes (blocks of threads lanes) at the
    merge's extremes, triangle ids n_sph.. n_sph + m - 1."""
    lane = torch.arange(r)
    tri = lambda k: n_sph + (k % m)  # noqa: E731
    if pattern == "one id a block":
        return tri(lane // threads * 97)
    if pattern == "distinct ids":
        return tri(torch.as_tensor(g.permutation(m)[:r]))
    if pattern == "one id on alternate warps":
        odd = (lane // 32) % 2 == 1
        return torch.where(odd, tri(lane * 131 + 7),
                           tri(lane // threads * 97))
    return torch.full((r,), -1)                     # every lane a miss


def _k6_merge_case(dev, pattern, poison=False):
    """K6 at trimesh's P = 10,496 on the chain's bounce-1 states with the
    winners of pattern: d_state equal to plain, d_table within 1e-4 of each
    group's max of the plain f64 sum and bit-equal to the fixed order over
    the plain lane terms, untouched rows exactly +0.0, two launches
    bit-equal. poison: first free NaN-filled tensors of the partials' and
    bitmaps' sizes, which the caching allocator hands back to the launch,
    so an entry read before it is written shows as NaN."""
    from tpu_ray_torch.kernels.bounce_step import (bounce_bwd_lanes_plain,
                                                   table_sum_fixed_order)
    tb, states, _ = _tri_fused_chain(dev, 64, 48)
    n, n_sph = tb.table.shape[0], tb.n_sph
    st = states[1]
    r = st.shape[1]
    g = np.random.default_rng(7)
    lib = build.load()
    threads = lib.trt_bounce_bwd_threads(n)
    idx = _merge_ids(pattern, r, threads, n_sph, n - n_sph, g).to(
        torch.int32).to(dev)
    d_out = torch.as_tensor(g.standard_normal(st.shape).astype(np.float32),
                            device=dev)
    d_out[12:16] = 0.0
    kw = dict(n_sph=n_sph, use_sky=True)
    parts = lib.trt_bounce_bwd_parts(r, n)
    outs = []
    for _ in range(2):
        if poison:
            junk = [torch.full((parts, n, 12), float("nan"), device=dev),
                    torch.full((parts, -(-n // 32)), -1, dtype=torch.int32,
                               device=dev)]
            del junk
        outs.append(bounce_bwd(st, tb.table, idx, 1, d_out.clone(), **kw))
    p = bounce_bwd_plain(st, tb.table, idx, 1, d_out.clone(), **kw)
    _, d_wn = bounce_bwd_lanes_plain(st, tb.table, idx, 1, d_out, **kw)
    fixed = table_sum_fixed_order(idx, d_wn, n, threads=threads,
                                  parts=parts)
    torch.cuda.synchronize()
    a, a2 = outs
    assert bool(torch.isfinite(p[0]).all() and torch.isfinite(p[1]).all())
    assert torch.equal(a[0], p[0])
    assert torch.equal(_bits(a[0]), _bits(a2[0]))
    assert torch.equal(_bits(a[1]), _bits(a2[1]))
    assert torch.equal(_bits(a[1]), _bits(fixed))
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    hit[idx[idx >= 0].long()] = True
    assert torch.equal(_bits(a[1][~hit]), torch.zeros_like(
        _bits(a[1][~hit])))
    for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                 slice(10, 11), slice(11, 12)):
        want = p[1][:, cols]
        assert (a[1][:, cols] - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one id a block", "distinct ids",
                                     "one id on alternate warps",
                                     "every lane a miss"])
def test_k6_merge_extremes_on_card(cuda_device, pattern):
    """K6's global-row merge at its extremes (trimesh's P = 10,496):
    every lane of a block on one id, every lane on its own id, one id on
    the even warps and distinct ids on the odd ones, no hit at all (no
    block touches a row: d_table all +0.0)."""
    _k6_merge_case(cuda_device, pattern)


@pytest.mark.cuda
def test_k6_merge_reads_no_unwritten_partial_on_card(cuda_device):
    """K6 right after NaN-filled tensors of its partials' and bitmaps'
    sizes are freed: no NaN reaches d_table, which equals the fixed
    order."""
    _k6_merge_case(cuda_device, "one id on alternate warps", poison=True)


@pytest.mark.cuda
def test_k3_reads_no_unwritten_partial_on_card(cuda_device):
    """K3's global-row branch (trimesh's records, 96x64 over blocks of
    several lane tiles) right after NaN-filled tensors of its partials' and
    bitmaps' sizes are freed: the same bits as a launch on fresh memory and
    as a second launch, d_state equal to plain, d_table and d_cam within
    1e-4 of each group's max, its counts consistent."""
    from tpu_ray_torch.kernels.bounce_step import MERGE_STATS
    table, _, n_tri, _, cam, kw, recs, d_out = _tri_records(cuda_device, 96,
                                                            64)
    n = table.shape[0]
    r = recs.t_end.shape[0]
    parts = build.load().trt_regen_bwd_parts(r, n)
    stats = torch.zeros(MERGE_STATS, dtype=torch.int64, device=cuda_device)
    a = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, stats=stats, **kw)
    junk = [torch.full((parts, n, 12), float("nan"), device=cuda_device),
            torch.full((parts, -(-n // 32)), -1, dtype=torch.int32,
                       device=cuda_device)]
    del junk
    a2 = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
    b = regen_bwd_plain(recs, d_out, cam, table, n_tri=n_tri, **kw)
    torch.cuda.synchronize()
    for x, x2 in zip(a, a2):
        assert torch.equal(_bits(x), _bits(x2))
    rows = list(range(12)) + [16, 17, 18]
    assert torch.equal(a[0][rows], b[0][rows])
    for cols in (slice(0, 3), slice(3, 4), slice(4, 7), slice(7, 10),
                 slice(10, 11), slice(11, 12)):
        want = b[1][:, cols]
        assert (a[1][:, cols] - want).abs().max() <= \
            1e-4 * want.abs().max()
    for k in range(0, 12, 3):
        want = b[2][k:k + 3]
        assert (a[2][k:k + 3] - want).abs().max() <= 1e-4 * want.abs().max()
    merges, sums, writes, firsts, most = stats.tolist()
    steps = recs.rec.shape[0]
    valid = torch.arange(steps, device=cuda_device)[:, None] < \
        recs.t_end.long()[None, :]
    ids = recs.rec[valid]
    rows_hit = int(torch.unique(ids[ids >= 0]).numel())
    threads = regen_bwd_info(n, cuda_device)["threads"]
    assert parts > 1 and 0 < firsts <= writes <= sums <= merges * threads
    assert rows_hit <= firsts <= parts * rows_hit and most <= rows_hit


@pytest.mark.cuda
def test_tri_per_sample_route_on_card(cuda_device):
    """trimesh on the per-sample route (K8, K5, K6): launches K8 every
    bounce, renders fused+regen's image, and its gradients are within
    3e-3 of each group's max of backend cuda autograd at 320x180, 2 spp,
    triangle leaves included."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.models.path_tracer import render_pass

    base = make_scene("trimesh", device=cuda_device)
    cam0 = default_camera(base)
    kw = dict(width=320, height=180, spp=2)
    before = bounce_fwd_list.launches
    a, ra = render_pass(base, cam0, backend="fused", regen=False, **kw)
    assert bounce_fwd_list.launches - before == 2 * 5
    b, rb = render_pass(base, cam0, backend="fused", regen=True, **kw)
    assert ra == rb and torch.equal(a, b)
    grads = {}
    for backend, regen in (("fused", False), ("cuda", False)):
        sc = trainable_scene(base)
        cam = trainable_camera(cam0)
        img = render_mean(sc, cam, backend=backend, regen=regen, **kw)
        image_mse(img, torch.zeros_like(img)).backward()
        grads[backend] = {k: sc.leaf(k).grad for k in sc.leaves}
        grads[backend]["position"] = cam.position.grad
    for k, want in grads["cuda"].items():
        got = grads["fused"][k]
        assert (got - want).abs().max() <= \
            3e-3 * want.abs().max().clamp_min(1e-12), k
    for k in ("tris.v0", "tris.e1", "tris.e2", "tris.albedo"):
        assert grads["fused"][k].abs().max() > 0, k


def _estimator_inputs(name, dev, w, h, lights=None):
    from tpu_ray_torch.core.scene import make_trilight_scene
    from tpu_ray_torch.kernels.regen import cam13
    from tpu_ray_torch.kernels.simple_shade import lane_rows, simple_tables
    from tpu_ray_torch.ops.shading_modes import scene_light_indices
    ts = (make_trilight_scene(device=dev) if name == "trilight"
          else make_scene(name, device=dev))
    lights = scene_light_indices(ts) if lights is None else lights
    tb = simple_tables(ts, lights,
                       origin_bound(default_camera(ts).position[None]))
    px = torch.as_tensor(tile_order(w, h)[0], device=dev)
    return tb, lane_rows(px, w, 0), cam13(default_camera(ts), 3)


def _k9_pair(args, kw, sph):
    """K9 and its plain version on the same inputs, with their counters
    -> (kernel out, plain out, kernel stats, plain stats)."""
    from tpu_ray_torch.kernels.simple_shade import (N_STATS, simple_trace,
                                                    simple_trace_plain)
    dev = args[0].device
    sk = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    sp = torch.zeros_like(sk)
    before = simple_trace.launches
    got = simple_trace(*args, **kw, sph=sph, stats=sk)
    torch.cuda.synchronize()
    assert simple_trace.launches == before + 1
    want = simple_trace_plain(*args, **kw, sph=sph, stats=sp)
    return got, want, sk, sp


def _k9_stats_agree(sk, sp):
    """The kernel's counters equal the plain version's, but the pairs
    tested (index 4), which K9's front-to-back walk cuts short of every
    listed pair."""
    k, p = sk.tolist(), sp.tolist()
    assert k[:4] == p[:4] and k[5:] == p[5:], (k, p)
    assert k[4] <= p[4], (k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("name,flat", [("single", True), ("sixteen", False),
                                       ("trimesh", True),
                                       ("trilight", False)])
def test_k9_matches_plain_on_card(cuda_device, name, flat):
    """K9 against simple_trace_plain bit for bit, flat and Lambert, on
    spheres and triangles, at 50x30 = 1,500 lanes (not a multiple of the
    256-lane block), 2 spp from sample 1, the spheres over their tiles;
    on a triangle scene with the primary and shadow block lists and with
    every tile swept; the counters equal the plain version's (the pairs
    tested at most its)."""
    tb, rows, cam = _estimator_inputs(name, cuda_device, 50, 30)
    kw = dict(n_sph=tb["n_sph"], spp=2, s0=1, width=50, height=30,
              use_sky=tb["use_sky"], flat=flat)
    for boxes in ((tb["boxes"], None) if tb["tri"] is not None
                  else (None,)):
        args = (rows, cam, tb["table"], tb["tri"], boxes, tb["lidx"],
                tb["ldat"])
        got, want, sk, sp = _k9_pair(args, kw, tb["sph"])
        assert torch.equal(got, want), (got - want).abs().max()
        assert float(got[3].min()) >= 2.0
        assert bool(torch.isfinite(got).all())
        _k9_stats_agree(sk, sp)
        assert sk[7] > 0
        assert (sk[2] > 0) == (tb["tri"] is not None)
        assert (sk[0] > 0) == (boxes is not None)
        if not flat and boxes is not None:
            assert sk[1] > 0 and sk[3] > 0


@pytest.mark.cuda
def test_k9_launch_raises_on_bad_input(cuda_device):
    """The wrapper refuses a wrong shape, a CPU tensor or no sphere
    tiles, and the launch refuses a sphere table past shared memory (no
    fallback)."""
    from tpu_ray_torch.kernels.simple_shade import simple_trace
    tb, rows, cam = _estimator_inputs("sixteen", cuda_device, 16, 16)
    kw = dict(n_sph=tb["n_sph"], spp=1, s0=0, width=16, height=16,
              use_sky=False, flat=False, sph=tb["sph"])
    args = (tb["table"], None, None, tb["lidx"], tb["ldat"])
    with pytest.raises(ValueError):
        simple_trace(rows[:2].contiguous(), cam, *args, **kw)
    with pytest.raises(ValueError):
        simple_trace(rows, cam.cpu(), *args, **kw)
    with pytest.raises(ValueError, match="sph"):
        simple_trace(rows, cam, *args, **dict(kw, sph=None))
    big = torch.zeros((20000, 12), device=cuda_device)
    with pytest.raises(RuntimeError, match="trt_simple_trace"):
        simple_trace(rows, cam, big, None, None, tb["lidx"], tb["ldat"],
                     **dict(kw, n_sph=20000, sph=sphere_tiles(big)))


@pytest.mark.cuda
def test_estimator_routes_on_card(cuda_device):
    """sixteen, Lambert, 64x48, 2 spp: the fused route launches K9 once a
    pass and renders backend cuda's image within 1e-5 (rays equal); its
    gradients (SimpleTrace's backward: the eager estimator on K1) within
    1e-5 of each group's max of backend cuda autograd, the lights'
    centre and emissive rows nonzero."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse
    from tpu_ray_torch.kernels.simple_shade import simple_trace
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.ops.shading_modes import scene_light_indices

    base = make_scene("sixteen", device=cuda_device)
    cam0 = default_camera(base)
    lights = scene_light_indices(base)
    kw = dict(width=64, height=48, spp=2, shading="lambert_shadow",
              lights=lights)
    before = simple_trace.launches
    a, ra = render_pass(base, cam0, backend="fused", **kw)
    assert simple_trace.launches - before == 1
    b, rb = render_pass(base, cam0, backend="cuda", **kw)
    assert ra == rb
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    grads = {}
    for backend in ("fused", "cuda"):
        sc = trainable_scene(base)
        cam = trainable_camera(cam0)
        k1 = sphere_nearest_hit.launches
        img, _ = render_pass(sc, cam, backend=backend, **kw)
        image_mse(img, torch.zeros_like(img)).backward()
        assert sphere_nearest_hit.launches > k1
        grads[backend] = {k: sc.leaf(k).grad for k in sc.leaves}
        grads[backend]["position"] = cam.position.grad
    for k, want in grads["cuda"].items():
        got = grads["fused"][k]
        assert (got - want).abs().max() <= \
            1e-5 * want.abs().max().clamp_min(1e-12), k
    for li in lights:
        assert grads["fused"]["center"][li].abs().max() > 0
        assert grads["fused"]["emissive"][li].abs().max() > 0


# the route past the residency rule: K10, the listed triangle search
def _stream_rays(dev, scene, w, h):
    """The scene's primary rays at w x h, then 4096 random rays from inside
    the scene, then 512 rays from above it pointing up (no tile is
    reached: their blocks' lists are empty)."""
    px = torch.arange(w * h, device=dev)
    o, d, _ = camera_rays(default_camera(scene), w, h, px, 0, 0)
    g = np.random.default_rng(5)
    o2 = torch.as_tensor(g.uniform(-0.2, 0.2, (4096, 3)).astype(np.float32),
                         device=dev)
    d2 = torch.nn.functional.normalize(torch.as_tensor(
        g.normal(size=(4096, 3)).astype(np.float32), device=dev), dim=1)
    o3 = torch.zeros((512, 3), device=dev)
    o3[:, 1] = 1e4
    d3 = torch.zeros((512, 3), device=dev)
    d3[:, 1] = 1.0
    return torch.cat([o, o2, o3]), torch.cat([d, d2, d3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trimesh", "bigmesh"])
def test_k10_matches_plain_on_card(cuda_device, name):
    """K10 bit-equal to tri_stream_plain on primary, scattered and
    upward rays, with every lane alive and with a dead block and dead
    lanes (which miss); blocks whose list is empty miss; two launches
    bit-equal; the launch counter counts launches only."""
    from tpu_ray_torch.kernels.bounce_step import tri_tile_boxes
    from tpu_ray_torch.kernels.tri_intersect import (tri_nearest_hit_stream,
                                                     tri_stream_plain)
    ts = make_scene(name, device=cuda_device)
    tab, boxes = tri_search_table(ts.tris), tri_tile_boxes(ts.tris)
    o, d = _stream_rays(cuda_device, ts, 64, 48)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    alive[256:512] = False
    alive[::7] = False
    for al in (None, alive):
        n0 = tri_nearest_hit_stream.launches
        a = tri_nearest_hit_stream(tab, boxes, o, d, al)
        a2 = tri_nearest_hit_stream(tab, boxes, o, d, al)
        b = tri_stream_plain(tab, boxes, o, d, al)
        torch.cuda.synchronize()
        assert tri_nearest_hit_stream.launches - n0 == 2
        assert torch.equal(a.idx, b.idx) and torch.equal(_bits(a.t),
                                                         _bits(b.t))
        assert torch.equal(a.idx, a2.idx) and torch.equal(_bits(a.t),
                                                          _bits(a2.t))
        assert bool((a.t[-512:] == 1e30).all())
        assert (a.t < 1e29).sum() > 1000
        if al is not None:
            assert bool((a.t[~al] == 1e30).all())
            assert bool((a.idx[~al] == 0).all())
    # against the full sweep (K7) on the primary rays: at most a grazing
    # hit outside its tile's box differs
    full = tri_nearest_hit(tab, o[:64 * 48], d[:64 * 48])
    k = tri_nearest_hit_stream(tab, boxes, o[:64 * 48], d[:64 * 48])
    torch.cuda.synchronize()
    assert int((k.idx != full.idx).sum()) <= 2


@pytest.mark.cuda
def test_stream_route_on_card(cuda_device):
    """bigmesh at 64x48, 1 spp: backend fused falls back to the probe
    route (K1 + K10) and renders what backend cuda renders over the same
    tile-ordered pixels (so the blocks, and their lists, are the same);
    the fwd+bwd with remat="save_hits" launches K10 in the forward only,
    and its gradients equal remat=False's."""
    from tpu_ray_torch.core.camera import trainable_camera
    from tpu_ray_torch.core.scene import trainable_scene
    from tpu_ray_torch.grad import image_mse, render_mean
    from tpu_ray_torch.kernels.tri_intersect import tri_nearest_hit_stream
    from tpu_ray_torch.models.path_tracer import (render_pass,
                                                  render_pixels,
                                                  untile_image)

    big = make_scene("bigmesh", device=cuda_device)
    cam0 = default_camera(big)
    kw = dict(width=64, height=48, spp=1)
    n0 = tri_nearest_hit_stream.launches
    a, ra = render_pass(big, cam0, backend="fused", **kw)
    assert tri_nearest_hit_stream.launches > n0
    perm = torch.as_tensor(tile_order(64, 48)[0], device=cuda_device)
    b, rb = render_pixels(big, cam0, perm, sample_start=0, backend="cuda",
                          **kw)
    assert ra == rb
    assert torch.equal(a, untile_image(b, 64, 48, perm))
    grads = {}
    for remat in (False, "save_hits"):
        sc, cam = trainable_scene(big), trainable_camera(cam0)
        img = render_mean(sc, cam, backend="fused", remat=remat, **kw)
        n1 = tri_nearest_hit_stream.launches
        image_mse(img, torch.zeros_like(img)).backward()
        assert tri_nearest_hit_stream.launches == n1
        grads[remat] = {k: sc.leaf(k).grad for k in sc.leaves}
    for k, want in grads[False].items():
        assert torch.isfinite(want).all(), k
        assert torch.equal(grads["save_hits"][k], want), k
    assert grads[False]["tris.v0"].abs().max() > 0


# K11 at bigmesh's triangle table: [163,968, 17], 2^21 lanes
K11_N, K11_W, K11_R = 163968, 17, 1 << 21


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["all on row 0", "random"])
def test_k11_matches_plain_on_card(cuda_device, pattern):
    """K11 bit for bit against its plain version on the card, two launches
    bit-equal, rows no lane gathers +0.0."""
    from tpu_ray_torch.kernels.gather_rows import (gather_rows_bwd,
                                                   gather_rows_bwd_plain)
    g = np.random.default_rng(11)
    idx = (np.zeros(K11_R, np.int32) if pattern == "all on row 0"
           else g.integers(0, K11_N, K11_R).astype(np.int32))
    idx = torch.as_tensor(idx, device=cuda_device)
    cot = torch.as_tensor(g.standard_normal((K11_R, K11_W))
                          .astype(np.float32), device=cuda_device)
    a = gather_rows_bwd(idx, cot, K11_N)
    b = gather_rows_bwd(idx, cot, K11_N)
    p = gather_rows_bwd_plain(idx, cot, K11_N)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), p.view(torch.int32))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    untouched = torch.bincount(idx.long(), minlength=K11_N) == 0
    assert untouched.any()
    assert not a[untouched].view(torch.int32).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 128, K11_N])
def test_k11_sort_is_torch_sort_on_card(cuda_device, n):
    """K11's own stable sort: keys and lane ids equal to
    torch.sort(stable=True)'s, and its fold over them the whole call's
    d_table bit for bit."""
    from tpu_ray_torch.kernels.gather_rows import (gather_rows_bwd,
                                                   gather_rows_fold,
                                                   stable_order)
    g = np.random.default_rng(13)
    idx = g.integers(0, n, K11_R).astype(np.int32)
    idx[g.random(K11_R) < 0.5] = 0
    idx = torch.as_tensor(idx, device=cuda_device)
    cot = torch.as_tensor(g.standard_normal((K11_R, K11_W))
                          .astype(np.float32), device=cuda_device)
    keys, ids = stable_order(idx, n)
    want_keys, want_ids = torch.sort(idx, stable=True)
    assert torch.equal(keys, want_keys)
    assert torch.equal(ids.long(), want_ids)
    a = gather_rows_fold(keys, ids, cot, n)
    b = gather_rows_bwd(idx, cot, n)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_gather_rows_backward_launches_k11_on_card(cuda_device):
    """GatherRows' backward on CUDA tensors is one K11 launch, whose
    d_table is the plain version's."""
    from tpu_ray_torch.kernels.gather_rows import (gather_rows_bwd,
                                                   gather_rows_bwd_plain)
    from tpu_ray_torch.ops.intersect import gather_rows
    g = np.random.default_rng(12)
    table = torch.tensor(g.standard_normal((128, 12)).astype(np.float32),
                         device=cuda_device, requires_grad=True)
    idx = torch.as_tensor(g.integers(0, 16, 1 << 16).astype(np.int32),
                          device=cuda_device)
    cot = torch.as_tensor(g.standard_normal((1 << 16, 12))
                          .astype(np.float32), device=cuda_device)
    out = gather_rows(table, idx)
    assert torch.equal(out, table.detach()[idx.long()])
    n0 = gather_rows_bwd.launches
    out.backward(cot)
    assert gather_rows_bwd.launches == n0 + 1
    want = gather_rows_bwd_plain(idx, cot, 128)
    assert torch.equal(table.grad.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_fused_regen_route_matches_native_oracle_on_card(cuda_device):
    """The main route (fused + regen, K2's culled sphere search) at 64x48
    against the port's native C++ oracle on the host: given the route's
    camera basis the oracle's image and rays bit for bit; with its own
    basis (reciprocal roots, an ulp from the route's) the bounds of
    tests/test_torch_examples.py against an oracle."""
    from tpu_ray_torch.kernels.regen import regen_steps
    from tpu_ray_torch.models.path_tracer import render_pass
    from tpu_ray_torch.oracle.native import NativeOracle
    scene = make_scene("rtweekend", device=cuda_device)
    cam = default_camera(scene)
    w, h, spp = 64, 48, 2
    n0 = regen_steps.culled_launches
    img, rays = render_pass(scene, cam, width=w, height=h, spp=spp,
                            backend="fused", regen=True)
    torch.cuda.synchronize()
    assert regen_steps.culled_launches == n0 + 1
    got = img.cpu().numpy()
    oracle = NativeOracle(scene)
    exact, exact_rays = oracle.render_pass(cam.position, cam.look_at, w, h,
                                           spp=spp, basis=cam.basis()[:3])
    assert rays == exact_rays
    np.testing.assert_array_equal(got, exact)
    own, own_rays = oracle.render_pass(cam.position, cam.look_at, w, h,
                                       spp=spp)
    assert np.isclose(got, own, rtol=1e-5, atol=1e-6).mean() >= 0.97
    off = np.abs(got - own).max(axis=-1) > 2e-3
    assert off.mean() <= 1 / 512, off.sum()
    assert abs(rays - own_rays) <= 4 * off.sum()
