"""One rank of the 2-rank ``gloo`` job that tests/test_torch_parallel.py
starts (it imports no JAX): every sharded case runs here once, and each
rank writes what it got to ``<out>/rank<r>.npz`` for the tests to read.

    WORLD_SIZE=2 RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_job.py OUT_DIR
"""
import importlib.util
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_ray_torch import cli  # noqa: E402
from tpu_ray_torch.core.camera import (camera_to_numpy,  # noqa: E402
                                       default_camera, trainable_camera)
from tpu_ray_torch.core.scene import (scene_to_numpy,  # noqa: E402
                                      trainable_scene)
from tpu_ray_torch.grad import image_mse, render_mean_sharded  # noqa: E402
from tpu_ray_torch.ops.raygen import camera_rays  # noqa: E402
from tpu_ray_torch.parallel import (make_mesh,  # noqa: E402
                                    probe_sphere_sharded,
                                    render_pass_sharded, shard_scene)
from tpu_ray_torch.parallel.multihost import ensure_initialized  # noqa: E402

# (case, scene, mesh, width, height, backend): the sharded passes
RENDERS = [("rtw_2", "rtweekend", (2,), 32, 32, "torch"),
           ("rtw_1x2", "rtweekend", (1, 2), 32, 32, "torch"),
           ("tri_1x2", "trimesh", (1, 2), 32, 16, "torch"),
           ("rtw_2_fused", "rtweekend", (2,), 32, 32, "fused")]
GRADS = [("grad_2", (2,)), ("grad_1x2", (1, 2))]
GW, GH = 16, 16                     # tests/test_grad.py:17-18
TIE_W, TIE_H = 32, 32
# the sharded example (tpu_ray_torch/examples/05_sharded_render.py) on the
# CPU: (case, its flags past the size); rtweekend, backend "cuda" (its
# default: the plain search on CPU tensors)
EX5 = [("ex5_2", ["--mesh", "2"]),
       ("ex5_1x2", ["--mesh", "1x2", "--backend", "cuda"])]
EX5_W, EX5_H = 32, 16
EXAMPLE5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_ray_torch", "examples", "05_sharded_render.py")


def case_scene(name):
    """The scenes of the cases (the tests build the same ones): trimesh
    at subdivision 1, and "dup", rgb with its five spheres copied into
    the second sphere shard's first slots, so every hit ties across
    shards."""
    from tpu_ray_torch.core.scene import make_scene, make_trimesh_scene
    if name == "trimesh":
        return make_trimesh_scene(subdivisions=1, device="cpu")
    if name == "dup":
        import dataclasses
        s = make_scene("rgb", device="cpu")
        half = s.n_pad // 2

        def dup(x):
            x = x.clone()
            x[half:half + s.n_real] = x[:s.n_real]
            return x
        return dataclasses.replace(s, **{
            k: dup(getattr(s, k)) for k in ("center", "radius", "albedo",
                                            "emissive", "specular", "ior")})
    return make_scene(name, device="cpu")


def main(out_dir: str) -> None:
    torch.set_num_threads(1)
    assert ensure_initialized(device_type="cpu")
    rank = torch.distributed.get_rank()
    got = {}
    meshes = {shape: make_mesh(shape, device_type="cpu")
              for shape in ((2,), (1, 2))}
    for case, name, shape, w, h, backend in RENDERS:
        scene = case_scene(name)
        img, rays = render_pass_sharded(
            scene, default_camera(scene), mesh=meshes[shape], width=w,
            height=h, spp=1, backend=backend, regen=backend == "fused")
        got[f"{case}/image"], got[f"{case}/rays"] = img.numpy(), rays
    for case, shape in GRADS:
        scene = case_scene("rtweekend")
        s, c = trainable_scene(scene), trainable_camera(default_camera(scene))
        img = render_mean_sharded(s, c, mesh=meshes[shape], width=GW,
                                  height=GH, spp=1)
        image_mse(img, torch.zeros_like(img)).backward()
        for k, v in {**scene_to_numpy(s, grad=True),
                     **camera_to_numpy(c, grad=True)}.items():
            got[f"{case}/{k}"] = v
    scene = case_scene("dup")
    cam = default_camera(scene)
    mesh = meshes[(1, 2)]
    o, d, _ = camera_rays(cam, TIE_W, TIE_H,
                          torch.arange(TIE_W * TIE_H), 0, 0)
    p = probe_sphere_sharded(shard_scene(scene, mesh), o, d, mesh=mesh)
    got["tie/idx"], got["tie/hit"] = p.idx.numpy(), p.hit.numpy()
    got["tie/image"] = render_pass_sharded(
        scene, cam, mesh=mesh, width=TIE_W, height=TIE_H, spp=1)[0].numpy()
    spec = importlib.util.spec_from_file_location("example05", EXAMPLE5)
    example5 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example5)
    for case, flags in EX5:
        got[f"{case}/image"] = example5.main(
            ["--device", "cpu", "--width", str(EX5_W), "--height",
             str(EX5_H), "--spp", "1", "--out",
             os.path.join(out_dir, f"{case}.png")] + flags).numpy()
    png = os.path.join(out_dir, "cli.png")
    assert cli.main(["render", "--device", "cpu", "--mesh", "1x2",
                     "--scene", "rgb", "--width", "32", "--height", "16",
                     "--spp", "1", "--passes", "2", "--out", png]) == 0
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
