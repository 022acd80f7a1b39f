"""Checkpoint / resume for progressive rendering (port of
``tpu_ray/utils/checkpoint.py``).

One npz file holds the accumulated mean image, the sample count, the
scene's arrays, the camera pose, the config and the rays cast so far, in
the JAX package's layout: the same array names, ``total_rays`` as u64,
``accum_samples`` as an i32 scalar, and ``meta_json`` (the scene's static
fields, ``tri_n_real`` for a triangle scene, the config) as u8 bytes. So
either package resumes the other's file. The config is written with the
JAX package's backend names and its keys (the two ``RenderConfig``s have
the same fields); the port's "torch" and "cuda" are its "jnp" and
"pallas".
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_ray_torch.config import RenderConfig
from tpu_ray_torch.core.camera import (Camera, camera_from_numpy,
                                       camera_to_numpy)
from tpu_ray_torch.core.scene import (SCENE_LEAVES, Scene, scene_from_numpy,
                                      scene_to_numpy)
from tpu_ray_torch.core.trimesh import TRI_LEAVES
from tpu_ray_torch.ops.accumulate import AccumState

_SCENE_STATIC = ("use_sky", "n_real", "default_distance", "default_x_angle",
                 "default_y_height")
# the port's backend names -> the JAX package's, in a file's config
_TO_JAX = {"torch": "jnp", "cuda": "pallas", "fused": "fused"}
_FROM_JAX = {v: k for k, v in _TO_JAX.items()}


def save_checkpoint(path: str, state: AccumState, scene: Scene,
                    camera: Camera, config: Optional[RenderConfig] = None,
                    total_rays: int = 0) -> None:
    """Write the npz (``np.savez_compressed`` appends .npz if missing)."""
    arrays = {
        "accum_mean": state.mean.detach().cpu().numpy(),
        "accum_samples": np.asarray(state.samples, np.int32),
        "total_rays": np.asarray(total_rays, np.uint64),
    }
    for k, v in camera_to_numpy(camera).items():
        arrays[f"camera_{k}"] = v
    leaves = scene_to_numpy(scene)
    for k in SCENE_LEAVES:
        arrays[f"scene_{k}"] = leaves[k]
    arrays["scene_look_at"] = scene.look_at.detach().cpu().numpy()
    meta = {f: getattr(scene, f) for f in _SCENE_STATIC}
    if scene.tris is not None:
        for k in TRI_LEAVES:
            arrays[f"tri_{k}"] = leaves[f"tris.{k}"]
        meta["tri_n_real"] = scene.tris.n_real
    if config is not None:
        cfg = dataclasses.asdict(config)
        cfg["backend"] = _TO_JAX[cfg["backend"]]
        meta["config"] = cfg
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[AccumState, Scene, Camera,
                               Optional[RenderConfig], int]:
    """-> (accum_state, scene, camera, config | None, total_rays), the
    tensors on ``device``."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # np.savez_compressed appended the suffix
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        cfg_dict = meta.pop("config", None)
        config = None
        if cfg_dict is not None:
            cfg_dict.pop("mesh_shape", None)  # a removed field (old files)
            cfg_dict["backend"] = _FROM_JAX[cfg_dict["backend"]]
            config = RenderConfig(**cfg_dict)
        tri_n_real = meta.pop("tri_n_real", None)
        arrays = {k: z[f"scene_{k}"] for k in SCENE_LEAVES + ("look_at",)}
        if tri_n_real is not None:
            arrays.update({f"tris.{k}": z[f"tri_{k}"] for k in TRI_LEAVES})
        scene = scene_from_numpy(arrays, device=device,
                                 tri_n_real=tri_n_real, **meta)
        camera = camera_from_numpy({"position": z["camera_position"],
                                    "look_at": z["camera_look_at"]},
                                   device=device)
        state = AccumState(
            mean=torch.tensor(z["accum_mean"], dtype=torch.float32,
                              device=device),
            samples=int(z["accum_samples"]))
        total_rays = int(z["total_rays"])
    return state, scene, camera, config, total_rays
