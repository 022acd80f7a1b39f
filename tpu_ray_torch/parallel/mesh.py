"""Device meshes and scene sharding on ``torch.distributed`` (port of
``tpu_ray/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every rank
of the process group, with dims ("rays",) or ("rays", "spheres"). Every
rank holds the whole scene (it is small, and built from the same seed
everywhere); ``shard_scene`` gives a rank its contiguous slice of the
primitive arrays on the "spheres" dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_ray_torch.core.scene import SCENE_LEAVES, Scene
from tpu_ray_torch.core.trimesh import TRI_LEAVES
from tpu_ray_torch.parallel.multihost import (check_device_type,
                                              ensure_initialized)

RAY_AXIS = "rays"
SPHERE_AXIS = "spheres"


def make_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("rays",) or ("rays", "spheres") mesh over every rank.

    mesh_shape () or None -> 1D over the world; (r,) -> 1D over r ranks;
    (r, s) -> 2D rays x spheres. The mesh must take the whole world (a
    ValueError says how many ranks it needs). The process group is joined
    first (``ensure_initialized``); a bare single process gets a group of
    one on an in-process store. device_type: "cuda" (the default; without
    a card it raises, naming the device, and starts no group) or "cpu" by
    name (a gloo group)."""
    check_device_type(device_type)
    ensure_initialized(device_type=device_type)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    shape = tuple(int(x) for x in mesh_shape) if mesh_shape else (world,)
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        raise ValueError(f"a mesh is (rays,) or (rays, spheres), got {shape}")
    n = math.prod(shape)
    if n != world:
        raise ValueError(
            f"mesh {shape} needs {n} ranks, the process group has {world}: "
            f"launch {n} (torchrun --nproc_per_node={n})")
    names = (RAY_AXIS,) if len(shape) == 1 else (RAY_AXIS, SPHERE_AXIS)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of the mesh's dim ``name`` (1 where it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate on the mesh's dim ``name`` (0 where it has
    none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(names.index(name)) if name in names else 0


def scene_pspec(scene: Scene, sphere_axis: Optional[str]
                ) -> Dict[str, Optional[str]]:
    """Each array field of ``scene`` (triangle fields as ``"tris.<name>"``)
    -> the mesh dim it is split over, or None where it is replicated.

    The per-sphere arrays and the triangle soup split over sphere_axis (a
    generic primitive axis; replicated when None); look_at replicates. By
    field name, never by shape: a triangle array whose padded length
    equals n_pad must not be taken for a sphere array."""
    spec = {k: sphere_axis for k in SCENE_LEAVES}
    spec["look_at"] = None
    if scene.tris is not None:
        spec.update({f"tris.{k}": sphere_axis for k in TRI_LEAVES})
    return spec


def shard_scene(scene: Scene, mesh: DeviceMesh) -> Scene:
    """This rank's view of ``scene`` on ``mesh``: per ``scene_pspec``, its
    contiguous slice of every split field (shards hold ascending blocks),
    the rest as it is. Slicing keeps autograd: a slice's gradient lands in
    its rows of the whole field."""
    if SPHERE_AXIS not in (mesh.mesh_dim_names or ()):
        return scene
    k, s = axis_index(mesh, SPHERE_AXIS), axis_size(mesh, SPHERE_AXIS)

    def part(x, what):
        if x.shape[0] % s:
            raise ValueError(f"{what}: {x.shape[0]} rows do not split "
                             f"over {s} sphere shards")
        rows = x.shape[0] // s
        return x[k * rows:(k + 1) * rows]

    spec = scene_pspec(scene, SPHERE_AXIS)
    tris = scene.tris
    if tris is not None:
        tris = dataclasses.replace(tris, **{
            f: part(getattr(tris, f), f"tris.{f}") for f in TRI_LEAVES
            if spec[f"tris.{f}"]})
    return dataclasses.replace(scene, tris=tris, **{
        f: part(getattr(scene, f), f) for f in SCENE_LEAVES if spec[f]})
