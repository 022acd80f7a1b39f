"""Inverse-rendering training step (port of ``tpu_ray/grad/fit.py``).

Fits scene parameters (sphere and triangle geometry + materials) and/or
the camera pose
to a target image by gradient descent on the photometric loss: forward
render, backward through the payload recompute, optimizer step. The
default optimizer is ``torch.optim.Adam(lr=1e-2)``, standing in for the
JAX package's ``optax.adam(1e-2)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_ray_torch.core.camera import CAMERA_LEAVES, Camera, trainable_camera
from tpu_ray_torch.core.scene import Scene, trainable_scene
from tpu_ray_torch.grad.render_grad import (image_mse, render_mean,
                                             render_mean_sharded)

# params (leaf name -> tensor, the trained leaves only) -> optimizer
OptimizerFactory = Callable[[Dict[str, torch.Tensor]], torch.optim.Optimizer]


@dataclasses.dataclass(frozen=True)
class TrainState:
    scene: Scene
    camera: Camera
    optimizer: torch.optim.Optimizer
    step: int


def make_train_step(*, width: int, height: int, spp: int, seed: int = 0,
                    max_bounces: int = 5, backend: str = "torch",
                    ray_chunk: Optional[int] = None,
                    mesh: Optional[DeviceMesh] = None,
                    optimizer: Optional[OptimizerFactory] = None,
                    train_camera: bool = True, train_scene: bool = True,
                    remat: Union[bool, str] = False,
                    cull_secondary: bool = False,
                    exact_argmin: bool = False, regen: bool = False,
                    fixed_samples: bool = False):
    """-> (init_fn(scene, camera) -> TrainState,
           step_fn(state, target) -> (TrainState, loss [] tensor)).

    init_fn copies the leaves into fresh tensors (``requires_grad`` on the
    trained ones: every scene leaf, ``Scene.leaves``, unless
    train_scene=False,
    ``position`` and ``look_at`` unless train_camera=False) and builds the
    optimizer over the trained leaves, by name. Each step_fn call renders
    spp fresh samples (sample_start advances by spp per step, so the
    estimator never reuses RNG streams); fixed_samples=True pins
    sample_start=0, a deterministic loss for fitting a target rendered
    with the same streams. The optimizer updates the leaves in place.
    remat (False, True, "save_hits" or "save_hits_bounce") goes to
    ``render_mean``, or with a mesh (``parallel.make_mesh``) to
    ``render_mean_sharded``, which every rank runs with the same target
    and which gives every rank the same gradients, so each rank's
    optimizer takes the same step; exact_argmin and cull_secondary change
    nothing (the port's search is always exact, and always culled)."""
    del exact_argmin, cull_secondary
    make_opt = optimizer or (
        lambda params: torch.optim.Adam(list(params.values()), lr=1e-2))

    def init_fn(scene: Scene, camera: Camera) -> TrainState:
        scene = trainable_scene(scene, scene.leaves if train_scene else ())
        camera = trainable_camera(camera,
                                  CAMERA_LEAVES if train_camera else ())
        params = {k: scene.leaf(k) for k in scene.leaves if train_scene}
        params.update({k: getattr(camera, k) for k in CAMERA_LEAVES
                       if train_camera})
        return TrainState(scene=scene, camera=camera,
                          optimizer=make_opt(params), step=0)

    def step_fn(state: TrainState, target):
        sample_start = 0 if fixed_samples else state.step * spp
        state.optimizer.zero_grad(set_to_none=True)
        kw = dict(width=width, height=height, spp=spp,
                  sample_start=sample_start, seed=seed,
                  max_bounces=max_bounces, backend=backend,
                  ray_chunk=ray_chunk, remat=remat, regen=regen)
        if mesh is None:
            image = render_mean(state.scene, state.camera, **kw)
        else:
            image = render_mean_sharded(state.scene, state.camera,
                                        mesh=mesh, **kw)
        loss = image_mse(image, target)
        loss.backward()
        state.optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), loss.detach()

    return init_fn, step_fn
