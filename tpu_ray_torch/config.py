"""Render configuration: the flag set of ``tpu_ray/config.py`` for the port.

Backends (the JAX package's names on the left):

  jnp            -> "torch"  plain PyTorch bounce loop (the anchor)
  pallas         -> "cuda"   the CUDA sphere- and triangle-search kernels
                             inside the eager bounce loop
                             (kernels/sphere_intersect.py,
                             kernels/tri_intersect.py)
  fused + regen  -> "fused"  the CUDA persistent-wavefront regen kernel
                   + regen   (kernels/regen.py), the default route on the
                             card, for sphere and triangle scenes
  fused          -> "fused"  the per-sample route through the CUDA bounce
                             kernels (kernels/bounce_step.py)

shading "flat" and "lambert_shadow" (ops/shading_modes.py) run eagerly on
"torch" and "cuda", and through the CUDA estimator kernel
(kernels/simple_shade.py) on "fused".

The gradient's memory policy is not a field here: ``remat`` of
``grad.render_mean`` and ``grad.make_train_step`` (False, True,
"save_hits", "save_hits_bounce") applies on "torch" and "cuda" and on the
route "fused" falls back to past the residency rule; "fused" ignores it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BACKENDS = ("torch", "cuda", "fused")
SHADINGS = ("path", "flat", "lambert_shadow")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene: str = "rtweekend"
    width: int = 960
    height: int = 540
    spp: int = 1                      # samples per render pass
    max_bounces: int = 5
    backend: str = "torch"            # 'torch' | 'cuda' | 'fused'
    seed: int = 0
    shading: str = "path"             # 'path' | 'flat' | 'lambert_shadow'
    ray_chunk: Optional[int] = None   # split the ray wavefront to bound memory
    exact_srgb: bool = False          # the reference ships the sqrt curve
    exact_argmin: bool = False        # accepted; the port's search is exact
    regen: bool = False               # fused backend: persistent wavefront
    cull_secondary: bool = False      # accepted (JAX's octant-split
                                      # culling of bounces 1..); K4 culls
                                      # every bounce (bit-identical)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.shading not in SHADINGS:
            raise ValueError(f"shading must be one of {SHADINGS}, "
                             f"got {self.shading!r}")
        if (self.ray_chunk is not None
                and (self.width * self.height) % self.ray_chunk):
            raise ValueError("ray_chunk must divide width*height")
