"""Render configuration: the flag set of ``tpu_ray/config.py`` for the port.

Backends (the JAX package's names on the left):

  jnp            -> "torch"  plain PyTorch bounce loop (the anchor)
  pallas         -> "cuda"   the CUDA sphere-search kernel inside the
                             eager bounce loop (kernels/sphere_intersect.py)
  fused + regen  -> "fused"  the CUDA persistent-wavefront regen kernel
                   + regen   (kernels/regen.py), the default route on the card
"""
from __future__ import annotations

import dataclasses
from typing import Optional

BACKENDS = ("torch", "cuda", "fused")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scene: str = "rtweekend"
    width: int = 960
    height: int = 540
    spp: int = 1                      # samples per render pass
    max_bounces: int = 5
    backend: str = "torch"            # 'torch' | 'cuda' | 'fused'
    seed: int = 0
    shading: str = "path"             # only 'path' is ported so far
    ray_chunk: Optional[int] = None   # split the ray wavefront to bound memory
    exact_srgb: bool = False          # the reference ships the sqrt curve
    regen: bool = False               # fused backend: persistent wavefront

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if (self.ray_chunk is not None
                and (self.width * self.height) % self.ray_chunk):
            raise ValueError("ray_chunk must divide width*height")
