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
from tpu_ray_torch.kernels.regen import regen_steps, regen_steps_plain, wave_init
from tpu_ray_torch.kernels.sphere_intersect import (nearest_hit_plain,
                                                    sphere_nearest_hit)
from tpu_ray_torch.models.path_tracer import tile_order

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
    regen_steps(st, cam, ts, 10, **kw)
    regen_steps_plain(ref, cam, ts, 10, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st[22], ref[22])
    assert (st[16:19] - ref[16:19]).abs().max().item() < 1e-5
