"""Sharded rendering on ``torch.distributed`` (port of ``tpu_ray/parallel``).

SPMD over processes, one rank a GPU (``torchrun``), laid out as a
``DeviceMesh``:

  "rays"    data parallelism over the [H*W] pixel wavefront: each rank
            renders its contiguous share, the colour rows are
            all-gathered;
  "spheres" optional second dim: each rank holds a slice of the
            primitive arrays and the winner over slices comes from an
            all-gather of the hit distances and an argmin.
"""

from tpu_ray_torch.parallel.mesh import (RAY_AXIS, SPHERE_AXIS, make_mesh,
                                         scene_pspec, shard_scene)
from tpu_ray_torch.parallel.render import (probe_sphere_sharded,
                                           render_pass_sharded)

__all__ = [
    "RAY_AXIS",
    "SPHERE_AXIS",
    "make_mesh",
    "scene_pspec",
    "shard_scene",
    "probe_sphere_sharded",
    "render_pass_sharded",
]
