"""Port parity, core layer: tpu_ray_torch.core against the JAX package.

The counter RNG must be bit-equal (every draw slot), the scene builders
array-equal, and the camera within 1e-6 (f32 trig and basis math).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.core import rng as jrng
from tpu_ray.core import scene as jscene
from tpu_ray.core import camera as jcamera
from tpu_ray.ops import raygen as jraygen

from tpu_ray_torch.core import rng
from tpu_ray_torch.core import scene as tscene
from tpu_ray_torch.core import camera as tcamera
from tpu_ray_torch.ops import raygen

SPHERE_SCENES = ["rgb", "randomized", "rtweekend", "single", "sixteen",
                 "sixtyfour"]
FIELDS = ("center", "radius", "albedo", "emissive", "specular", "ior",
          "look_at")
STATIC = ("use_sky", "n_real", "default_distance", "default_x_angle",
          "default_y_height")


def _u32(x):
    return torch.as_tensor(np.asarray(x, np.uint32).astype(np.int64))


@pytest.fixture(scope="module")
def counters():
    g = np.random.default_rng(7)
    return (g.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32),
            g.integers(0, 1920 * 1080, 4096).astype(np.uint32),
            g.integers(0, 4096, 4096).astype(np.uint32))


def test_pcg_hash_bit_equal(counters):
    x, _, _ = counters
    np.testing.assert_array_equal(
        rng.pcg_hash(_u32(x)).numpy().astype(np.uint32),
        jrng.pcg_hash(x, np))


@pytest.mark.parametrize("seed", [0, 123, 0xFFFFFFFF])
def test_ray_base_bit_equal(counters, seed):
    _, pixel, sample = counters
    np.testing.assert_array_equal(
        rng.ray_base(seed, _u32(pixel), _u32(sample)).numpy().astype(np.uint32),
        jrng.ray_base(seed, pixel, sample, np))


# every slot of the convention (rng.py:16-19) at the bounces that use it
@pytest.mark.parametrize("bounce,slot,lo,hi", [
    (0, 4, -0.5, 0.5), (0, 5, -0.5, 0.5),
    (0, 0, -1.0, 1.0), (1, 1, -1.0, 1.0), (2, 2, -1.0, 1.0),
    (3, 3, 0.0, 1.0), (4, 0, -1.0, 1.0)])
def test_draws_bit_equal(counters, bounce, slot, lo, hi):
    _, pixel, sample = counters
    base_np = jrng.ray_base(5, pixel, sample, np)
    base = _u32(base_np)
    np.testing.assert_array_equal(
        rng.draw_u32(base, bounce, slot).numpy().astype(np.uint32),
        jrng.draw_u32(base_np, bounce, slot, np))
    np.testing.assert_array_equal(
        rng.draw_uniform(base, bounce, slot, lo, hi).numpy(),
        jrng.draw_uniform(base_np, bounce, slot, lo, hi, np))
    # the bounce may also be a per-ray tensor (the regen bounce row)
    b = torch.full((base.shape[0],), bounce, dtype=torch.int64)
    np.testing.assert_array_equal(
        rng.draw_u32(base, b, slot).numpy().astype(np.uint32),
        jrng.draw_u32(base_np, bounce, slot, np))


def test_u32_bits_round_trip(counters):
    x, _, _ = counters
    u = _u32(x)
    bits = rng.u32_to_bits(u)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), x)
    np.testing.assert_array_equal(rng.bits_to_u32(bits).numpy(), u.numpy())


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_scene_builders_array_equal(name):
    ref = jscene.make_scene(name)
    got = tscene.make_scene(name, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in STATIC:
        assert getattr(got, f) == getattr(ref, f), f
    assert got.n_pad == ref.n_pad


@pytest.mark.parametrize("name", ["rgb", "rtweekend"])
def test_scene_from_numpy_matches_make_scene(name):
    ref = jscene.make_scene(name)
    carried = tscene.scene_from_numpy(
        {f: np.asarray(getattr(ref, f)) for f in FIELDS}, device="cpu",
        **{f: getattr(ref, f) for f in STATIC})
    own = tscene.make_scene(name, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(carried, f), getattr(own, f)), f
    for f in STATIC:
        assert getattr(carried, f) == getattr(own, f), f


def test_unported_scenes_refuse():
    """Triangle scenes build (trimesh, an obj: mesh, index 6); the routes
    that are not ported refuse them, citing ROADMAP.md: bigmesh (past
    resident_tables_fit) on every backend, and the per-sample fused route
    (fused without regen) on any triangle scene."""
    from tpu_ray_torch.core.camera import default_camera
    from tpu_ray_torch.models.path_tracer import render_pass

    obj = os.path.join(os.path.dirname(__file__), "fixtures", "ico1.obj")
    for name in ("trimesh", f"obj:{obj}", 6):
        assert tscene.make_scene(name, device="cpu").tris is not None
    big = tscene.make_scene("bigmesh", device="cpu")
    tri = tscene.make_scene("trimesh", device="cpu")
    cases = [(big, dict(backend=b, regen=b == "fused"))
             for b in ("torch", "cuda", "fused")]
    cases.append((tri, dict(backend="fused", regen=False)))
    for scene, kw in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render_pass(scene, default_camera(scene), width=8, height=8,
                        spp=1, **kw)


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_camera_basis(name):
    jc = jcamera.default_camera(jscene.make_scene(name))
    tc = tcamera.default_camera(tscene.make_scene(name, device="cpu"))
    np.testing.assert_allclose(tc.position.numpy(), np.asarray(jc.position),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(tc.basis(), jc.basis()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("wh", [(32, 24), (24, 32), (1920, 1080), (7, 7)])
def test_film_extent(wh):
    np.testing.assert_allclose(tcamera.film_extent(*wh),
                               jcamera.film_extent(*wh), rtol=1e-6)


def test_camera_from_numpy():
    jc = jcamera.default_camera(jscene.make_scene("rtweekend"))
    tc = tcamera.camera_from_numpy(
        {"position": np.asarray(jc.position),
         "look_at": np.asarray(jc.look_at)}, device="cpu")
    np.testing.assert_array_equal(tc.position.numpy(), np.asarray(jc.position))
    np.testing.assert_array_equal(tc.look_at.numpy(), np.asarray(jc.look_at))


@pytest.mark.parametrize("name,w,h,sample,seed", [
    ("rtweekend", 32, 24, 0, 0), ("rgb", 40, 30, 3, 11),
    ("randomized", 24, 32, 1, 5)])
def test_camera_rays(name, w, h, sample, seed):
    """Same camera fed to both: bases equal, directions within 1e-6."""
    jc = jcamera.default_camera(jscene.make_scene(name))
    tc = tcamera.camera_from_numpy(
        {"position": np.asarray(jc.position),
         "look_at": np.asarray(jc.look_at)}, device="cpu")
    pixel = np.arange(w * h, dtype=np.int32)
    jo, jd, jb = jraygen.camera_rays(jc, w, h, jnp.asarray(pixel), sample,
                                     seed)
    o, d, b = raygen.camera_rays(tc, w, h, torch.as_tensor(pixel).long(),
                                 sample, seed)
    np.testing.assert_array_equal(b.numpy().astype(np.uint32), np.asarray(jb))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
