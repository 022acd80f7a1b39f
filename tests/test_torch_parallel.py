"""Port parity, sharding on ``torch.distributed``: ``parallel`` and
``grad.render_mean_sharded`` in a 2-rank ``gloo`` job on the CPU.

One module fixture starts a single job of two processes
(tests/torch_parallel_job.py, ``torchrun``'s environment variables); it
runs every case once and the tests below read its results, so each case
counts as a test without a job of its own. The cases, as the JAX suite
sizes them (tests/test_parallel.py, tests/test_grad.py:17-18):

- ``render_pass_sharded`` on meshes (2,) and (1, 2), rtweekend 32x32,
  1 spp (backend "torch", and "fused" + regen on (2,)), and trimesh
  (subdivision 1) 32x16 on (1, 2): every rank's image bit for bit the
  port's single-process ``render_pass``, the rays equal; and against JAX's
  ``render_pass_sharded`` on the same mesh shape (the conftest's virtual
  CPU devices) to the bounds of the port's render tests against JAX
  (tests/test_torch_render.py: rays exact, rtweekend within rtol 1e-5 /
  atol 1e-6 on >= 0.97 of pixels; tests/test_torch_tri_ops.py: the
  triangle route within rtol 1e-5 / atol 1e-6). The golden test's "within
  2e-3 everywhere" (32x24) holds here for all but 1 pixel in 512: at
  32x32 one pixel of 1,024 differs by 0.0112 in the port's single-process
  render against JAX's too (measured), a path whose 1-ulp difference
  (ROADMAP.md queue C) takes the other branch at a dielectric.
- ``render_mean_sharded`` gradients on (2,) and (1, 2), rtweekend 16x16:
  every rank's within tests/test_grad.py:140-146's bound (rtol 1e-4, atol
  1e-7 + 1e-5 of each leaf's max) of one process's; a gradient off by the
  world size (2) fails it.
- The sphere-sharded probe's tie rule: rgb with its spheres copied into
  the second shard, so every hit ties across shards; the winner is the
  lowest global id, the single process's.
- ``render --mesh 1x2`` through the CLI: rank 0's PNG equal to one
  process's.
- The sharded example (tpu_ray_torch/examples/05_sharded_render.py) with
  ``--device cpu --mesh 2`` and ``--mesh 1x2 --backend cuda``, rtweekend
  32x16, 1 spp: every rank's image bit for bit one process's
  ``render_pass``.
- ``make_mesh`` with no device asks for the card: without one it fails
  naming the device and starts no group, and ``device_type="cpu"`` builds
  a gloo mesh (a subprocess, so the test worker keeps no group).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.parallel import make_mesh as jmake_mesh
from tpu_ray.parallel import render_pass_sharded as jrender_pass_sharded
from tpu_ray.parallel import shard_scene as jshard_scene

from tests.test_torch_threads import one_thread  # noqa: F401
from tests.torch_parallel_job import (EX5, EX5_H, EX5_W, GH, GRADS, GW,
                                      RENDERS, TIE_H, TIE_W, case_scene)
from tpu_ray_torch import cli
from tpu_ray_torch.core.camera import (camera_to_numpy, default_camera,
                                       trainable_camera)
from tpu_ray_torch.core.scene import (make_trimesh_scene, scene_to_numpy,
                                      trainable_scene)
from tpu_ray_torch.grad import image_mse, render_mean
from tpu_ray_torch.models.path_tracer import probe_for, render_pass
from tpu_ray_torch.ops.raygen import camera_rays
from tpu_ray_torch.parallel import SPHERE_AXIS, scene_pspec
from tpu_ray_torch.parallel.multihost import ensure_initialized

JOB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_parallel_job.py")
RENDER = {c[0]: c[1:] for c in RENDERS}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Both ranks' results of one 2-rank gloo job, and its directory."""
    out = tmp_path_factory.mktemp("job")
    env = {**os.environ, "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, JOB, str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)], out


def _single(case):
    name, _, w, h, backend = RENDER[case]
    scene = case_scene(name)
    img, rays = render_pass(scene, default_camera(scene), width=w, height=h,
                            spp=1, backend=backend, regen=backend == "fused")
    return img.numpy(), rays


@pytest.mark.parametrize("case", list(RENDER))
def test_sharded_render_equals_single_process(job, case):
    ranks, _ = job
    img, rays = _single(case)
    for got in ranks:
        assert int(got[f"{case}/rays"]) == rays
        np.testing.assert_array_equal(got[f"{case}/image"], img)
    assert img.mean() > 0


@pytest.fixture(scope="module")
def jax_images():
    """JAX's render_pass_sharded of the backend-"torch" cases, on the
    same mesh shapes over the conftest's virtual CPU devices."""
    out = {}
    for case, (name, shape, w, h, backend) in RENDER.items():
        if backend != "torch":
            continue
        scene = (jmake_trimesh(subdivisions=1) if name == "trimesh"
                 else jmake_scene(name))
        mesh = jmake_mesh(shape)
        img, rays = jrender_pass_sharded(
            jshard_scene(scene, mesh), jdefault_camera(scene), mesh=mesh,
            width=w, height=h, spp=1, sample_start=0, seed=0)
        out[case] = np.asarray(img), int(rays)
    return out


@pytest.mark.parametrize("case", ["rtw_2", "rtw_1x2", "tri_1x2"])
def test_sharded_render_matches_jax(job, jax_images, case):
    ranks, _ = job
    ref, rays = jax_images[case]
    got = ranks[0][f"{case}/image"]
    assert int(ranks[0][f"{case}/rays"]) == rays
    ok = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(axis=-1)
    if RENDER[case][0] == "trimesh":
        assert ok.all(), ok.mean()
    else:
        assert ok.mean() >= 0.97, ok.mean()
        off = np.abs(got - ref).max(axis=-1) >= 2e-3
        assert off.mean() <= 1 / 512, off.sum()


@pytest.fixture(scope="module")
def single_grads():
    scene = case_scene("rtweekend")
    s, c = trainable_scene(scene), trainable_camera(default_camera(scene))
    img = render_mean(s, c, width=GW, height=GH, spp=1)
    image_mse(img, torch.zeros_like(img)).backward()
    return {**scene_to_numpy(s, grad=True), **camera_to_numpy(c, grad=True)}


@pytest.mark.parametrize("case", [c for c, _ in GRADS])
def test_sharded_grads_equal_single_process(job, single_grads, case):
    ranks, _ = job
    nonzero = 0
    for got in ranks:
        for k, b in single_grads.items():
            np.testing.assert_allclose(
                got[f"{case}/{k}"], b, rtol=1e-4,
                atol=1e-7 + 1e-5 * max(1e-30, np.abs(b).max()),
                err_msg=f"{case} {k}")
            nonzero += float(np.abs(b).sum()) > 0
    assert nonzero >= 2 * 4


def test_sphere_sharded_probe_keeps_lowest_id(job):
    ranks, _ = job
    scene = case_scene("dup")
    cam = default_camera(scene)
    o, d, _ = camera_rays(cam, TIE_W, TIE_H, torch.arange(TIE_W * TIE_H),
                          0, 0)
    p = probe_for(scene, "torch")(scene, o, d)
    img, _ = render_pass(scene, cam, width=TIE_W, height=TIE_H, spp=1)
    hit = p.hit.numpy()
    assert hit.any()
    assert (p.idx.numpy()[hit] < scene.n_pad // 2).all()
    for got in ranks:
        np.testing.assert_array_equal(got["tie/hit"], hit)
        np.testing.assert_array_equal(got["tie/idx"][hit],
                                      p.idx.numpy()[hit])
        np.testing.assert_array_equal(got["tie/image"], img.numpy())


def test_cli_render_mesh(job, tmp_path):
    _, out = job
    png = tmp_path / "one.png"
    assert cli.main(["render", "--device", "cpu", "--scene", "rgb",
                     "--width", "32", "--height", "16", "--spp", "1",
                     "--passes", "2", "--out", str(png)]) == 0
    assert (out / "cli.png").read_bytes() == png.read_bytes()


@pytest.mark.parametrize("case", [c for c, _ in EX5])
def test_sharded_example_equals_single_process(job, case):
    """examples/05 under the job's two ranks, --mesh 2 and 1x2 on backend
    "cuda": every rank's image bit for bit one process's render_pass."""
    ranks, out = job
    scene = case_scene("rtweekend")
    img, _ = render_pass(scene, default_camera(scene), width=EX5_W,
                         height=EX5_H, spp=1, backend="cuda")
    for got in ranks:
        np.testing.assert_array_equal(got[f"{case}/image"], img.numpy())
    assert (out / f"{case}.png").stat().st_size > 100


def test_make_mesh_defaults_to_the_card():
    """make_mesh() names no device: it asks for "cuda", and without a card
    it fails naming the device and starts no group; "cpu" by name still
    builds a gloo mesh. In a subprocess, so no group is left in the test
    worker."""
    code = (
        "import torch.distributed as dist\n"
        "from tpu_ray_torch.parallel import make_mesh\n"
        "mesh = make_mesh((1,), device_type='cpu')\n"
        "print(dist.get_backend(), mesh.device_type, tuple(mesh.shape))\n"
        "dist.destroy_process_group()\n"
        "try:\n"
        "    make_mesh((1,))\n"
        "finally:\n"
        "    print('initialized', dist.is_initialized())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=root,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.split("\n")[:2] == ["gloo cpu (1,)",
                                         "initialized False"], p.stdout
    assert "device_type 'cuda': no CUDA device" in p.stderr, p.stderr


def test_scene_pspec_names_fields():
    """By field name: trimesh at subdivision 0 pads its triangles to 128
    rows, as many as the sphere table has."""
    scene = make_trimesh_scene(subdivisions=0, device="cpu")
    assert scene.tris.n_pad == scene.n_pad
    spec = scene_pspec(scene, SPHERE_AXIS)
    assert spec.pop("look_at") is None
    assert set(spec) == set(scene.leaves)
    assert set(spec.values()) == {SPHERE_AXIS}
    assert set(scene_pspec(scene, None).values()) == {None}


def test_multihost_noop_single_process():
    assert ensure_initialized() is False
    assert not torch.distributed.is_initialized()
    assert jax.process_count() == 1
