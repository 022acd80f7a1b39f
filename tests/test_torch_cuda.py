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
from tpu_ray_torch.kernels.regen import (regen_bwd, regen_bwd_plain,
                                         regen_record, regen_steps,
                                         regen_steps_plain, wave_init)
from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                    sphere_nearest_hit)
from tpu_ray_torch.models.path_tracer import tile_order
from tpu_ray_torch.ops.intersect import payload_tables

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
