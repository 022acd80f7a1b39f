"""The port's oracles (``tpu_ray_torch/oracle``) against the JAX package's.

The counter RNG's NumPy copy is held bit for bit against
``tpu_ray/core/rng.py`` (``xp=numpy``) and the port's int64 torch RNG; the
port's NumPy ``CpuOracle`` bit for bit against JAX's (the same ops on the
same scene bits); the port's ``NativeOracle`` (its own copy of the C++
oracle, built by g++ into the port's build directory) against JAX's
``CpuOracle`` at the bounds of ``tests/test_native_oracle.py``; its thread
count changes no bit; two processes that build it at once into an empty
directory both load a whole library; and the port's eager route
(``backend="torch"``) against it at the bounds of
``tests/test_forward_parity.py``. Nothing here is held against JAX's
``NativeOracle``. Small films: the NumPy oracles loop over pixels.
"""
import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_ray.core import rng as jrng
from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh_scene
from tpu_ray.oracle.cpu_oracle import CpuOracle as JCpuOracle
from tpu_ray_torch.core import rng as trng
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene, make_trimesh_scene
from tpu_ray_torch.models.path_tracer import render_pass
from tpu_ray_torch.oracle import CpuOracle, _rng
from tpu_ray_torch.oracle import native
from tpu_ray_torch.oracle.native import NativeOracle, native_available

from tests.test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_scene(name):
    if name == "trimesh":
        return make_trimesh_scene(subdivisions=1, device="cpu")
    return make_scene(name, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_oracle(name, w, h):
    """JAX's NumPy oracle on its own scene and camera, 1 spp, seed 0."""
    scene = (jmake_trimesh_scene(subdivisions=1) if name == "trimesh"
             else jmake_scene(name))
    cam = jdefault_camera(scene)
    return JCpuOracle(scene).render_pass(
        np.asarray(cam.position), np.asarray(cam.look_at), w, h, spp=1)


def _port_oracle(oracle_cls, name, w, h, **kw):
    scene = _port_scene(name)
    cam = default_camera(scene)
    return oracle_cls(scene, **kw).render_pass(cam.position, cam.look_at,
                                               w, h, spp=1)


def test_oracle_rng_bit_equal_to_both_packages():
    seeds = [0, 1, 5, 12345, 0x7FFFFFFF, 0xFFFFFFFF, 2 ** 32 + 3]
    pixel = np.concatenate([np.arange(0, 4096, 7),
                            [2 ** 21 - 1, 1920 * 1080 - 1, 2 ** 31 + 5,
                             2 ** 32 - 1]]).astype(np.uint32)
    sample = np.array([0, 1, 2, 63, 64, 1000, 2 ** 31], np.uint32)
    p_grid = np.repeat(pixel, len(sample))
    s_grid = np.tile(sample, len(pixel))
    for seed in seeds:
        base = _rng.ray_base(seed, p_grid, s_grid)
        assert base.dtype == np.uint32
        np.testing.assert_array_equal(
            base, jrng.ray_base(seed, p_grid, s_grid, np))
        tbase = trng.ray_base(seed, torch.as_tensor(p_grid.astype(np.int64)),
                              torch.as_tensor(s_grid.astype(np.int64)))
        np.testing.assert_array_equal(base.astype(np.int64), tbase.numpy())
        for bounce in (0, 1, 4, 7):
            for slot in range(6):
                u = _rng.draw_u32(base, bounce, slot)
                np.testing.assert_array_equal(
                    u, jrng.draw_u32(base, bounce, slot, np))
                np.testing.assert_array_equal(
                    u.astype(np.int64),
                    trng.draw_u32(tbase, bounce, slot).numpy())
                lo, hi = (-0.5, 0.5) if slot >= 4 else (-1.0, 1.0)
                f = _rng.draw_uniform(base, bounce, slot, lo, hi)
                assert f.dtype == np.float32
                np.testing.assert_array_equal(
                    f.view(np.uint32),
                    jrng.draw_uniform(base, bounce, slot, lo, hi,
                                      np).view(np.uint32))
                np.testing.assert_array_equal(
                    f, trng.draw_uniform(tbase, bounce, slot, lo,
                                         hi).numpy())
    # the oracle's loop draws on 0-d arrays and a traced bounce may be an
    # array: both forms give the same bits
    b0 = _rng.ray_base(7, np.asarray(12, np.uint32), np.asarray(3, np.uint32))
    assert b0 == jrng.ray_base(7, np.asarray(12, np.uint32),
                               np.asarray(3, np.uint32), np)
    assert (_rng.draw_u32(b0, 2, 3)
            == _rng.draw_u32(b0, np.asarray(2, np.uint32), 3)
            == jrng.draw_u32(b0, 2, 3, np))


@pytest.mark.parametrize("name,wh", [("rgb", 32), ("rtweekend", 16),
                                     ("trimesh", 24)])
def test_cpu_oracle_bit_equal_to_jax(name, wh):
    img, rays = _port_oracle(CpuOracle, name, wh, wh)
    ref, ref_rays = _jax_oracle(name, wh, wh)
    assert rays == ref_rays
    assert img.dtype == np.float32 and img.shape == (wh, wh, 3)
    np.testing.assert_array_equal(img.view(np.uint32), ref.view(np.uint32))
    assert img.mean() > 0.01


def test_native_oracle_bit_exact_on_rgb():
    img, rays = _port_oracle(NativeOracle, "rgb", 32, 32)
    ref, ref_rays = _jax_oracle("rgb", 32, 32)
    assert rays == ref_rays
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("name", ["randomized", "rtweekend"])
def test_native_oracle_statistical(name):
    img, rays = _port_oracle(NativeOracle, name, 32, 32)
    ref, ref_rays = _jax_oracle(name, 32, 32)
    # rays-cast totals may differ only via near-tie path divergence
    assert abs(rays - ref_rays) <= 0.01 * ref_rays
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff < 1e-5).mean() > 0.95, (diff < 1e-5).mean()
    assert np.median(diff) == 0.0


def test_native_oracle_trimesh():
    img, rays = _port_oracle(NativeOracle, "trimesh", 24, 24, n_threads=2)
    ref, ref_rays = _jax_oracle("trimesh", 24, 24)
    assert rays == ref_rays
    match = np.abs(img - ref).max(axis=-1) < 1e-6
    assert match.mean() > 0.995, match.mean()


def test_native_oracle_thread_count_changes_no_bit():
    scene = make_scene("rtweekend", device="cpu")
    cam = default_camera(scene)
    a, ra = NativeOracle(scene, n_threads=1).render_pass(
        cam.position, cam.look_at, 64, 64, spp=2)
    b, rb = NativeOracle(scene, n_threads=8).render_pass(
        cam.position, cam.look_at, 64, 64, spp=2)
    # disjoint tile writes + per-pixel sample order => thread-count invariant
    assert ra == rb
    np.testing.assert_array_equal(a, b)


_BUILD_AND_RENDER = r"""
import os, sys, time
from tpu_ray_torch.core.camera import default_camera
from tpu_ray_torch.core.scene import make_scene
from tpu_ray_torch.oracle import native
build_dir, ready, go = sys.argv[1:4]
open(ready + str(os.getpid()), "w").close()
t_end = time.time() + 60
while not os.path.exists(go):
    if time.time() > t_end:
        sys.exit("no go")
    time.sleep(0.005)
lib = native.build(build_dir)
native._lib = native.bind(lib)
scene = make_scene("rgb", device="cpu")
cam = default_camera(scene)
img, rays = native.NativeOracle(scene).render_pass(cam.position,
                                                   cam.look_at, 8, 8)
print(lib, rays, float(img.sum()), native.build_info["cached"])
"""


def test_native_build_two_processes_at_once(tmp_path):
    """Two processes build into one empty directory at once: each compiles
    into a file of its own and moves it into place, so both load a whole
    library and render the same image, and no temporary file is left."""
    build_dir = str(tmp_path / "build")
    ready, go = str(tmp_path / "ready."), str(tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, "-c", _BUILD_AND_RENDER, build_dir, ready, go]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT) for _ in range(2)]
    t_end = time.time() + 120
    while (len([f for f in os.listdir(tmp_path) if f.startswith("ready.")])
           < 2 and time.time() < t_end
           and all(p.poll() is None for p in procs)):
        time.sleep(0.01)
    open(go, "w").close()
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = [out.split() for out, _ in outs]
    assert lines[0][:3] == lines[1][:3], lines
    assert lines[0][0] == native.lib_path(build_dir)
    assert int(lines[0][1]) >= 64
    assert os.listdir(build_dir) == [os.path.basename(lines[0][0])]


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "oracle.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == []
    assert native_available()


@pytest.mark.parametrize("name,wh,spp,seed,max_abs", [
    ("rgb", 24, 2, 0, 1e-6),
    ("randomized", 16, 1, 3, 1e-5),
    # sky + dielectrics + speculars: ~1e-4 worst case
    ("rtweekend", 16, 1, 1, 5e-4),
])
def test_eager_route_matches_native_oracle(name, wh, spp, seed, max_abs):
    scene = make_scene(name, device="cpu")
    cam = default_camera(scene)
    img, rays = render_pass(scene, cam, width=wh, height=wh, spp=spp,
                            seed=seed, backend="torch")
    oimg, orays = NativeOracle(scene).render_pass(
        cam.position, cam.look_at, wh, wh, spp=spp, seed=seed)
    assert int(rays) == orays
    diff = np.abs(img.numpy() - oimg)
    assert diff.max() <= max_abs, diff.max()
    assert img.mean().item() > 0.01


@pytest.mark.parametrize("name,wh,spp,backend,regen", [
    ("rtweekend", 48, 2, "torch", False),
    ("rtweekend", 48, 2, "fused", True),
    ("trimesh", 24, 2, "torch", False),
])
def test_native_oracle_given_the_port_basis_is_bit_equal(name, wh, spp,
                                                          backend, regen):
    """The oracle builds its camera basis with reciprocal roots, the port's
    camera divides: one ulp apart in x and y on rtweekend's camera, which
    moves every primary ray. Given the port's basis, the oracle repeats the
    port's f32 ops: the image and the rays bit for bit."""
    scene = _port_scene(name)
    cam = default_camera(scene)
    img, rays = render_pass(scene, cam, width=wh, height=wh, spp=spp,
                            seed=2, backend=backend, regen=regen)
    oimg, orays = NativeOracle(scene).render_pass(
        cam.position, cam.look_at, wh, wh, spp=spp, seed=2,
        basis=cam.basis()[:3])
    assert int(rays) == orays
    np.testing.assert_array_equal(img.numpy(), oimg)
    own, _ = NativeOracle(scene).render_pass(cam.position, cam.look_at, wh,
                                             wh, spp=spp, seed=2)
    if name == "rtweekend":
        assert not np.array_equal(own, oimg)
