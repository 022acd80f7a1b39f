"""The plain reference against itself, and against the program's eager
route, at tiny sizes on the CPU."""
import numpy as np
import pytest
import torch

from benchmark import reference, scenes


def _scene(kind, dtype=torch.float32, grad=False):
    arrays, static = scenes.build({"kind": kind})
    pos, la = scenes.orbit(arrays["look_at"], static)
    return (arrays, static, reference.Scene(arrays, static, "cpu", dtype, grad),
            torch.tensor(pos), torch.tensor(la))


@pytest.mark.parametrize("kind", ["rtweekend", "trimesh"])
def test_cull_is_exact(kind):
    """The boxes' cull gives every winner the search of every pair gives,
    on rays from the camera and from points on and near the primitives."""
    _, _, sc, pos, _ = _scene(kind)
    g = torch.Generator().manual_seed(3)
    n = 3000
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    o = torch.cat([pos.expand(n // 3, 3),
                   sc.leaves["center"][torch.randint(0, 8, (n // 3,),
                                                     generator=g)]
                   + 0.02 * torch.randn(n // 3, 3, generator=g),
                   0.1 * torch.randn(n - 2 * (n // 3), 3, generator=g)])
    got = reference.search(sc, o, d, cull=True)
    want = reference.search(sc, o, d, cull=False)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
            continue
        assert torch.equal(a, b)
        assert (a >= 0).any()


@pytest.mark.parametrize("kind", ["rtweekend", "trimesh"])
def test_render_does_not_depend_on_grouping_or_cull(kind):
    _, _, sc, pos, la = _scene(kind)
    kw = dict(width=16, height=9, spp=3, sample_start=5, seed=2 ** 31 + 9,
              max_bounces=5)
    px = torch.arange(16 * 9)
    a, ra = reference.render(sc, pos, la, pixels=px, **kw)
    b, rb = reference.render(sc, pos, la, pixels=px, lanes=16 * 9, **kw)
    c, rc = reference.render(sc, pos, la, pixels=px, cull=False, **kw)
    sub, rs = reference.render(sc, pos, la, pixels=px[::7], **kw)
    assert torch.equal(a, b) and torch.equal(a, c) and ra == rb == rc
    assert torch.equal(a[::7], sub) and 0 < rs < ra


def test_replayed_gradient_matches_autograd_of_the_search():
    """The backward re-traced from recorded winners gives the gradient of
    a trace that searches again under autograd."""
    _, _, sc, pos, la = _scene("rtweekend", grad=True)
    pos.requires_grad_()
    la.requires_grad_()
    kw = dict(width=12, height=8, pixel=torch.arange(96), sample=4,
              seed=11, max_bounces=5)
    c, _, _ = reference.trace(sc, pos, la, **kw)
    torch.sum(c * torch.linspace(0.1, 1.0, 3)).backward()
    want = {k: v.grad.clone() for k, v in sc.leaves.items()}
    want_pos = pos.grad.clone()
    for v in list(sc.leaves.values()) + [pos, la]:
        v.grad = None
    total, _ = reference.render(
        sc, pos, la, width=12, height=8, pixels=torch.arange(96), spp=1,
        sample_start=4, seed=11, max_bounces=5,
        cotangent=lambda t: torch.linspace(0.1, 1.0, 3).expand(96, 3))
    assert torch.allclose(total, c.detach())
    for k, v in sc.leaves.items():
        torch.testing.assert_close(v.grad, want[k], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(pos.grad, want_pos, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kind", ["rtweekend", "trimesh"])
def test_bit_for_bit_the_programs_eager_route(kind):
    """The reference repeats the program's eager route (backend "torch")
    op for op: the same image and rays, bit for bit, on the CPU."""
    from tpu_ray_torch.core.camera import Camera
    from tpu_ray_torch.core.scene import scene_from_numpy
    from tpu_ray_torch.grad.render_grad import render_mean
    arrays, static, sc, pos, la = _scene(kind)
    prog = scene_from_numpy(arrays, device="cpu",
                            tri_n_real=static["tri_n_real"] or None,
                            use_sky=static["use_sky"], n_real=static["n_real"])
    img, rays = render_mean(prog, Camera(pos, la), width=24, height=14, spp=2,
                            sample_start=6, seed=77, backend="torch",
                            return_rays=True)
    total, ref_rays = reference.render(
        sc, pos, la, width=24, height=14, pixels=torch.arange(24 * 14),
        spp=2, sample_start=6, seed=77, max_bounces=5)
    ref_img = (total / torch.tensor(2.0)).reshape(14, 24, 3)
    assert rays == ref_rays
    np.testing.assert_array_equal(img.numpy(), ref_img.numpy())


def test_lower_precision_runs():
    """The control's precision: every value in bfloat16, and it renders."""
    _, _, sc, pos, la = _scene("rtweekend", torch.bfloat16)
    total, rays = reference.render(
        sc, pos.bfloat16(), la.bfloat16(), width=8, height=6,
        pixels=torch.arange(48), spp=1, sample_start=0, seed=1,
        max_bounces=5)
    assert total.dtype == torch.bfloat16 and rays > 0
    assert torch.isfinite(total.float()).all()
