"""Orbit camera (reference main.cpp:730-781, 811-822).

Basis Z = normalize(pos - look_at), X = normalize(cross(up, Z)),
Y = normalize(cross(Z, X)); the film plane is centred at pos - Z with
aspect-corrected extents.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from tpu_ray_torch.core.scene import Scene


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # [3] f32
    look_at: torch.Tensor   # [3] f32

    def basis(self):
        """-> (cam_x, cam_y, cam_z, film_center). Reference main.cpp:811-814."""
        # imported here: tpu_ray_torch.utils imports this module
        from tpu_ray_torch.utils.metrics import to_device
        up = to_device([0.0, 1.0, 0.0], self.position.device, torch.float32)
        z = _normalize(self.position - self.look_at)
        x = _normalize(torch.linalg.cross(up, z))
        y = _normalize(torch.linalg.cross(z, x))
        film_center = self.position - z
        return x, y, z, film_center


def _normalize(v):
    # exact sqrt + divide, reference v3::Normalize (x64_math.h:234-245)
    return v / torch.sqrt(torch.sum(v * v))


def film_extent(width: int, height: int):
    """Aspect-corrected film extents (reference main.cpp:816-822)."""
    film_w = film_h = 1.0
    if width > height:
        film_h = float(height) / float(width)
    else:
        film_w = float(width) / float(height)
    return np.float32(film_w), np.float32(film_h)


def orbit_camera(look_at, distance, x_angle, y_height,
                 device="cuda") -> Camera:
    """Orbit pose -> Camera (reference main.cpp:776-781)."""
    look_at = torch.as_tensor(np.asarray(look_at, np.float32), device=device)
    x_angle = torch.tensor(float(x_angle), dtype=torch.float32, device=device)
    xy = torch.stack([torch.cos(x_angle), torch.sin(x_angle)]) * float(distance)
    y = torch.tensor(float(y_height), dtype=torch.float32, device=device)
    position = torch.stack([xy[0], y, xy[1]])
    return Camera(position=position + look_at, look_at=look_at)


def default_camera(scene: Scene) -> Camera:
    """Scene's default orbit pose (reference main.cpp:722-725), on the
    scene's device."""
    return orbit_camera(scene.look_at.cpu().numpy(), scene.default_distance,
                        scene.default_x_angle, scene.default_y_height,
                        device=scene.device)


CAMERA_LEAVES = ("position", "look_at")


def camera_from_numpy(d: Dict[str, np.ndarray], device="cuda",
                      requires_grad: bool = False) -> Camera:
    """Camera from numpy ``position`` and ``look_at`` arrays (e.g. a JAX
    Camera's fields); ``requires_grad`` makes both trainable."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=requires_grad)
    return Camera(position=t(d["position"]), look_at=t(d["look_at"]))


def camera_to_numpy(camera: Camera, grad: bool = False) -> Dict[str, np.ndarray]:
    """``position`` and ``look_at`` (or, with ``grad``, their ``.grad``,
    zeros where none was accumulated) as numpy arrays."""
    out = {}
    for k in CAMERA_LEAVES:
        v = getattr(camera, k)
        if grad:
            v = v.grad if v.grad is not None else torch.zeros_like(v)
        out[k] = v.detach().cpu().numpy()
    return out


def trainable_camera(camera: Camera, names=CAMERA_LEAVES) -> Camera:
    """A copy of ``camera`` whose leaves in ``names`` require grad."""
    return Camera(**{k: getattr(camera, k).detach().clone()
                     .requires_grad_(k in names) for k in CAMERA_LEAVES})
