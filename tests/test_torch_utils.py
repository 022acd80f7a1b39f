"""Port parity, ``tpu_ray_torch.utils``: checkpoints in the JAX package's
npz layout, read by either package unchanged (a port file by
``tpu_ray.utils.load_checkpoint``, a JAX file by the port's), on a sphere
scene and a triangle scene; the config's backend names mapped ("torch"
<-> "jnp", "cuda" <-> "pallas") and its other fields carried; and the
metrics helpers (``MetricsLogger.log_pass``, ``hard_timeit``,
``profiler_trace``). Every array round-trips bit for bit, and the rays
count past 2^32 (u64)."""
import io
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_ray.config import RenderConfig as JRenderConfig
from tpu_ray.core.camera import default_camera as jdefault_camera
from tpu_ray.core.scene import make_scene as jmake_scene
from tpu_ray.core.scene import make_trimesh_scene as jmake_trimesh
from tpu_ray.ops.accumulate import AccumState as JAccumState
from tpu_ray.utils import load_checkpoint as jload
from tpu_ray.utils import save_checkpoint as jsave

from tpu_ray_torch import RenderConfig
from tpu_ray_torch.core.camera import camera_to_numpy, default_camera
from tpu_ray_torch.core.scene import (make_scene, make_trimesh_scene,
                                      scene_to_numpy)
from tpu_ray_torch.ops.accumulate import AccumState
from tpu_ray_torch.utils import (MetricsLogger, StepTimer, load_checkpoint,
                                 save_checkpoint, write_png)
from tpu_ray_torch.utils.metrics import hard_timeit, profiler_trace

RAYS = 5_000_000_007          # past 2^32: the count is u64
SCENES = {"rgb": (lambda: make_scene("rgb", device="cpu"),
                  lambda: jmake_scene("rgb")),
          "trimesh": (lambda: make_trimesh_scene(subdivisions=1,
                                                 device="cpu"),
                      lambda: jmake_trimesh(subdivisions=1))}
STATIC = ("use_sky", "n_real", "default_distance", "default_x_angle",
          "default_y_height")


def _mean(h=6, w=8):
    return np.random.default_rng(5).random((h, w, 3)).astype(np.float32)


def _jax_arrays(scene):
    """A JAX scene's arrays under the port's leaf names."""
    out = {k: np.asarray(getattr(scene, k))
           for k in ("center", "radius", "albedo", "emissive", "specular",
                     "ior", "look_at")}
    if scene.tris is not None:
        out.update({f"tris.{k}": np.asarray(getattr(scene.tris, k))
                    for k in ("v0", "e1", "e2", "albedo", "emissive",
                              "specular", "ior")})
    return out


def _port_arrays(scene):
    out = scene_to_numpy(scene)
    out["look_at"] = scene.look_at.numpy()
    return out


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("backend,jax_backend",
                         [("torch", "jnp"), ("cuda", "pallas"),
                          ("fused", "fused")])
def test_port_checkpoint_loads_in_jax(tmp_path, name, backend, jax_backend):
    scene = SCENES[name][0]()
    cam = default_camera(scene)
    cfg = RenderConfig(scene=name, width=8, height=6, spp=3,
                       backend=backend, seed=4, exact_argmin=True,
                       cull_secondary=True, regen=backend == "fused")
    mean = _mean()
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, AccumState(mean=torch.as_tensor(mean), samples=6),
                    scene, cam, cfg, RAYS)
    state, jscene, jcam, jcfg, rays = jload(path)
    assert rays == RAYS
    np.testing.assert_array_equal(np.asarray(state.mean), mean)
    assert int(state.samples) == 6
    assert np.asarray(state.samples).dtype == np.int32
    assert jcfg == JRenderConfig(scene=name, width=8, height=6, spp=3,
                                 backend=jax_backend, seed=4,
                                 exact_argmin=True, cull_secondary=True,
                                 regen=backend == "fused")
    want = _port_arrays(scene)
    got = _jax_arrays(jscene)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k in STATIC:
        assert getattr(jscene, k) == getattr(scene, k), k
    assert (jscene.tris is None) == (scene.tris is None)
    if scene.tris is not None:
        assert jscene.tris.n_real == scene.tris.n_real
    for k, v in camera_to_numpy(cam).items():
        np.testing.assert_array_equal(np.asarray(getattr(jcam, k)), v)


@pytest.mark.parametrize("name", list(SCENES))
def test_jax_checkpoint_loads_in_port(tmp_path, name):
    jscene = SCENES[name][1]()
    jcam = jdefault_camera(jscene)
    jcfg = JRenderConfig(scene=name, width=8, height=6, spp=2,
                         backend="pallas", seed=9, shading="flat",
                         exact_argmin=True)
    mean = _mean()
    path = str(tmp_path / "jax")          # the .npz suffix is appended
    jsave(path, JAccumState(mean=jnp.asarray(mean),
                            samples=jnp.asarray(4, jnp.int32)),
          jscene, jcam, jcfg, RAYS)
    state, scene, cam, cfg, rays = load_checkpoint(path, device="cpu")
    assert rays == RAYS and state.samples == 4
    assert isinstance(state.samples, int)
    np.testing.assert_array_equal(state.mean.numpy(), mean)
    assert cfg == RenderConfig(scene=name, width=8, height=6, spp=2,
                               backend="cuda", seed=9, shading="flat",
                               exact_argmin=True)
    want = _jax_arrays(jscene)
    got = _port_arrays(scene)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k in STATIC:
        assert getattr(scene, k) == getattr(jscene, k), k
    if jscene.tris is not None:
        assert scene.tris.n_real == jscene.tris.n_real
    for k, v in camera_to_numpy(cam).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jcam, k)))


def test_checkpoint_without_config(tmp_path):
    scene = make_scene("rgb", device="cpu")
    path = str(tmp_path / "bare.npz")
    save_checkpoint(path, AccumState.zeros(2, 3, device="cpu"), scene,
                    default_camera(scene))
    state, _, _, cfg, rays = load_checkpoint(path, device="cpu")
    assert cfg is None and rays == 0 and state.samples == 0
    assert tuple(state.mean.shape) == (2, 3, 3)


def test_log_pass_fields():
    buf = io.StringIO()
    log = MetricsLogger(stream=buf)
    rec = log.log_pass(rays=2000, seconds=0.5, render_pass=1, samples=8)
    log.log_pass(rays=0, seconds=0.0, frame=0)
    first, second = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert first == rec
    assert (first["rays_cast"], first["seconds"], first["rays_per_s"],
            first["ns_per_ray"]) == (2000, 0.5, 4000.0, 250000.0)
    assert (first["render_pass"], first["samples"]) == (1, 8)
    assert second["rays_per_s"] is None and second["ns_per_ray"] is None
    assert "ts" in first


def test_hard_timeit_and_step_timer():
    calls = []

    def step(x):
        calls.append(1)
        return {"out": x * 2.0}

    secs = hard_timeit(step, torch.ones(4), iters=3)
    assert secs >= 0.0 and len(calls) == 4     # one warm-up call
    out, s = StepTimer.timed(step, torch.ones(2))
    assert torch.equal(out["out"], torch.full((2,), 2.0)) and s >= 0.0


def test_profiler_trace(tmp_path):
    with profiler_trace(None):
        pass
    d = str(tmp_path / "trace")
    with profiler_trace(d):
        torch.ones(8).add_(1.0)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(d, files[0])) as f:
        assert "traceEvents" in json.load(f)


def test_utils_exports(tmp_path):
    p = str(tmp_path / "x.png")
    write_png(p, np.zeros((2, 2, 4), np.uint8))
    assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
