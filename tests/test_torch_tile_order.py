"""The tile order built on the device (``models/path_tracer.tile_pixels``)
and the untile through it (``untile_image``): the table equals
``tile_order``'s perm and is made without a host table, the untile and its
backward are bit-equal to the gather by ``inv`` and its autograd
gradient, and the fused route untiles through its own table, which it
leaves unwritten. The last test runs on the card at 1920x1080 (marked
``cuda``; it skips where there is no GPU). This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tile_order.py -q
"""
import numpy as np
import pytest
import torch

from test_torch_threads import one_thread  # noqa: F401 (autouse fixture)
from tpu_ray_torch import PathTracer, RenderConfig
from tpu_ray_torch.core.camera import default_camera, trainable_camera
from tpu_ray_torch.core.scene import make_scene, trainable_scene
from tpu_ray_torch.grad import render_grad
from tpu_ray_torch.models import path_tracer
from tpu_ray_torch.models.path_tracer import (tile_order, tile_pixels,
                                              untile_image)


@pytest.mark.parametrize("w,h,tile", [
    (8, 8, 32), (32, 24, 32), (64, 40, 32), (160, 72, 32), (70, 40, 32),
    (33, 65, 32), (7, 5, 8), (64, 64, 8)])
def test_device_table_is_the_tile_order(w, h, tile):
    got = tile_pixels(w, h, "cpu", tile=tile)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), tile_order(w, h, tile)[0])


def test_table_is_made_without_a_host_table(monkeypatch):
    def refused(*_):
        raise AssertionError("a host table was made")
    monkeypatch.setattr(path_tracer, "_tile_order", refused)
    assert tile_pixels(70, 40, torch.device("cpu")).shape == (70 * 40,)


@pytest.mark.parametrize("w,h", [(8, 8), (70, 40), (33, 65)])
def test_untile_is_the_inverse_gather_bit_for_bit(w, h):
    perm, inv = tile_order(w, h)
    g = torch.Generator().manual_seed(w * h)
    color = torch.randn((w * h, 3), generator=g)
    up = torch.randn((h, w, 3), generator=g)
    up[0, 0] = -0.0
    ref_in = color.clone().requires_grad_()
    ref = ref_in[torch.as_tensor(inv)].reshape(h, w, 3)
    ref.backward(up)
    got_in = color.clone().requires_grad_()
    got = untile_image(got_in, w, h, torch.as_tensor(perm))
    got.backward(up)
    assert torch.equal(got, ref)
    assert torch.equal(got_in.grad, ref_in.grad)


def graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is not None and f not in seen:
            seen.add(f)
            todo += [g for g, _ in f.next_functions]
    return {type(f).__name__ for f in seen}


def test_route_untiles_through_its_table_and_leaves_it_unwritten(
        monkeypatch):
    w, h, kw = 8, 8, dict(spp=1, max_bounces=2, backend="fused", regen=True)
    made = []

    def kept(*a, **k):
        table = tile_pixels(*a, **k)
        made.append((table, table._version))
        return table
    monkeypatch.setattr(render_grad, "tile_pixels", kept)
    monkeypatch.setattr(path_tracer, "tile_pixels", kept)
    scene = trainable_scene(make_scene("rtweekend", device="cpu"))
    camera = trainable_camera(default_camera(scene))
    img = render_grad.render_mean(scene, camera, width=w, height=h, **kw)
    assert "_UntileBackward" in graph_nodes(img.grad_fn)
    render_grad.image_mse(img, torch.zeros_like(img)).backward()
    tracer = PathTracer(RenderConfig(scene="rtweekend", width=w, height=h,
                                     **kw), device="cpu")
    tracer.step(tracer.init_state())
    assert len(made) == 2
    for table, version in made:
        assert table._version == version
        assert np.array_equal(table.numpy(), tile_order(w, h)[0])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_table_and_untile_on_the_card(cuda_device):
    w, h = 1920, 1080
    perm, inv = tile_order(w, h)
    order = tile_pixels(w, h, cuda_device)
    assert torch.equal(order.cpu(), torch.as_tensor(perm))
    g = torch.Generator(device=cuda_device).manual_seed(5)
    color = torch.randn((w * h, 3), generator=g, device=cuda_device)
    up = torch.randn((h, w, 3), generator=g, device=cuda_device)
    ref_in = color.clone().requires_grad_()
    ref = ref_in[torch.as_tensor(inv, device=cuda_device)].reshape(h, w, 3)
    ref.backward(up)
    got_in = color.clone().requires_grad_()
    got = untile_image(got_in, w, h, order)
    got.backward(up)
    assert torch.equal(got, ref)
    assert torch.equal(got_in.grad, ref_in.grad)
