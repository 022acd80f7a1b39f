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
    bounce_fwd, bounce_fwd_plain, bounce_replay, bounce_replay_plain,
    init_state, morton_perm, permute_spheres, scene_table)
from tpu_ray_torch.kernels.regen import (regen_bwd, regen_bwd_plain,
                                         regen_record, regen_steps,
                                         regen_steps_plain, regen_tables,
                                         wave_init)
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
    assert build.load().trt_bounce_bwd_parts(650 * 350) == 256
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
    (650x350 = 227,500 lanes over the 256 blocks), on rtweekend (the
    partial row in shared memory) and trimesh (in global memory)."""
    assert build.load().trt_regen_bwd_parts(650 * 350) == 256
    for name in ("rtweekend", "trimesh"):
        table, _, n_tri, _, cam, kw, recs, d_out = _tri_records(
            cuda_device, 650, 350, name)
        a = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
        a2 = regen_bwd(recs, d_out, cam, table, n_tri=n_tri, **kw)
        torch.cuda.synchronize()
        for x, x2 in zip(a, a2):
            assert torch.equal(_bits(x), _bits(x2))
        assert a[1].abs().max() > 0


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
