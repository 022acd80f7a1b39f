"""tpu_ray_torch: the PyTorch / CUDA port of the tpu_ray path tracer.

A progressive Monte-Carlo path tracer over sphere and triangle scenes,
differentiable for inverse rendering (``grad/``). The module layout
mirrors the JAX package (``tpu_ray/``) file for file; the Pallas kernels
of its render and its gradient are hand-written CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use and bound with ctypes
(``kernels/build.py``).

Entry points take ``device=`` and default to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of every kernel.
"""

from tpu_ray_torch.config import RenderConfig
from tpu_ray_torch.core.camera import Camera, default_camera, orbit_camera
from tpu_ray_torch.core.scene import (SCENE_BUILDERS, Scene, SceneBuilder,
                                      make_scene)
from tpu_ray_torch.models.path_tracer import PathTracer

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "Camera",
    "PathTracer",
    "make_scene",
    "SCENE_BUILDERS",
    "orbit_camera",
    "default_camera",
]
