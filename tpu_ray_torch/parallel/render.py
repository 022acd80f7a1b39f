"""The sharded progressive render pass (port of
``tpu_ray/parallel/render.py``), SPMD over the ranks of a mesh.

The flat pixel axis splits evenly over the "rays" dim: each rank renders
its contiguous share of the pixel order (the 32x32-tile order on
"fused"), and the colour rows are all-gathered over "rays", so every rank
ends with the whole image. The scene is whole on every rank, or split
over "spheres", where each rank searches its own primitive slice and the
winner over shards comes from an all-gather of the hit distances
(``probe_sphere_sharded``). The rays-cast count is summed over "rays"
only: the sphere shards of a row trace the same rays.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_ray_torch.core.camera import Camera
from tpu_ray_torch.core.scene import Scene
from tpu_ray_torch.models.path_tracer import (_SEARCH, _TRI_SEARCH, HitTape,
                                              _search, render_pixels,
                                              tile_pixels, untile_image)
from tpu_ray_torch.ops.intersect import Hit, Payload, hit_payload
from tpu_ray_torch.ops.intersect_tri import (merge_payloads, tri_payload,
                                             tri_search_table)
from tpu_ray_torch.ops.shading_modes import scene_light_data
from tpu_ray_torch.parallel.mesh import (RAY_AXIS, SPHERE_AXIS, axis_index,
                                         axis_size, shard_scene)

# the payload's float fields and their widths, all-gathered as one
# [R, 15] row a ray
_FLOATS = (("t", 1), ("next_origin", 3), ("normal_raw", 3), ("albedo", 3),
           ("emissive", 3), ("specular", 1), ("ior", 1))


def _gathered(x, group, n: int):
    """All-gather of x over group (n ranks) -> [n, *x.shape], no
    autograd."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _GatherSummed(torch.autograd.Function):
    """All-gather over group -> [n, *x.shape] whose backward is a
    reduce-scatter: each rank's gradient is the sum over the group's ranks
    of their gradients of its slot (an all-reduce of the [n, ...]
    gradient, the rank's own slot taken)."""

    @staticmethod
    def forward(ctx, x, group, n: int, slot: int):
        ctx.group, ctx.slot = group, slot
        return _gathered(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.slot], None, None, None


def probe_sphere_sharded(scene_local: Scene, origins, directions, *,
                         mesh: DeviceMesh, backend: str = "torch",
                         alive=None, tape: Optional[HitTape] = None
                         ) -> Payload:
    """The nearest-hit probe when the primitive arrays (spheres and the
    triangle soup) are split over the mesh's "spheres" dim.

    Each rank searches its own slice with backend's searches ("torch" or
    "cuda": K1 and K7 on the card) and computes the differentiable payload
    of its local winner; the winner over shards is the argmin of the
    all-gathered hit distances, and its payload is picked from an
    all-gather that carries autograd (``_GatherSummed``: its backward
    sums each shard's payload gradient over the shards). Ties go to the lowest shard, and
    shards hold ascending blocks, so a tie goes to the lowest global id,
    the unsharded search's rule. Global ids are [all shards' spheres | all
    shards' triangles], the unsharded convention. tape: records or
    replays each local search and the shard winner (remat "save_hits*").
    alive is accepted for the probe signature; the local searches sweep
    every lane."""
    del alive
    group = mesh.get_group(SPHERE_AXIS)
    shard, n_shards = (axis_index(mesh, SPHERE_AXIS),
                       axis_size(mesh, SPHERE_AXIS))
    n_local = scene_local.n_pad
    hit = _search(tape, n_local, _SEARCH[backend], scene_local.center,
                  scene_local.radius, origins, directions)
    p = hit_payload(scene_local, origins, directions, hit)
    p = p._replace(idx=p.idx + shard * n_local)
    t_local = hit.t
    if scene_local.tris is not None:
        m_local = scene_local.tris.n_pad
        th = _search(tape, m_local, _TRI_SEARCH[backend],
                     tri_search_table(scene_local.tris), origins, directions)
        tp = tri_payload(scene_local.tris, origins, directions, th)
        # triangle global ids sit after every shard's spheres
        p = merge_payloads(p, tp, n_local * n_shards + shard * m_local)
        t_local = torch.minimum(t_local, th.t)

    def winner() -> Hit:
        t_min, win = torch.min(_gathered(t_local, group, n_shards), dim=0)
        return Hit(t=t_min, idx=win.to(torch.int32))

    win = _search(tape, n_shards, winner).idx.long()
    r = origins.shape[0]
    floats = torch.cat([getattr(p, f).reshape(r, w) for f, w in _FLOATS],
                       1)
    ints = torch.stack([p.hit.to(torch.int32), p.idx,
                        p.inside.to(torch.int32)], 1)
    f_all = _GatherSummed.apply(floats, group, n_shards, shard)
    i_all = _gathered(ints, group, n_shards)
    f = torch.gather(f_all, 0, win[None, :, None].expand(
        1, r, floats.shape[1]))[0]
    i = torch.gather(i_all, 0, win[None, :, None].expand(1, r, 3))[0]
    parts = f.split([w for _, w in _FLOATS], 1)
    out = {name: x if w == 3 else x[:, 0]
           for (name, w), x in zip(_FLOATS, parts)}
    return Payload(hit=i[:, 0].bool(), idx=i[:, 1], inside=i[:, 2].bool(),
                   **out)


class _GatherRays(torch.autograd.Function):
    """All-gather of each rank's colour rows over "rays" -> the whole
    [n, 3] buffer on every rank. The backward assumes what
    ``render_mean_sharded`` asks of its caller, a loss that every rank
    computes alike from the whole image: it takes the rank's own rows of
    the (equal) gradient, divided by the "spheres" size, whose shards
    trace the same rays and whose payload all-gather sums them again."""

    @staticmethod
    def forward(ctx, color, mesh):
        out = _gathered(color, mesh.get_group(RAY_AXIS),
                        axis_size(mesh, RAY_AXIS))
        ctx.rows = axis_index(mesh, RAY_AXIS), color.shape[0]
        ctx.n_sph = axis_size(mesh, SPHERE_AXIS)
        return out.reshape(-1, color.shape[1])

    @staticmethod
    def backward(ctx, grad):
        k, rows = ctx.rows
        return grad[k * rows:(k + 1) * rows] / ctx.n_sph, None


def _plan(scene: Scene, mesh: DeviceMesh, width: int, height: int,
          backend: str):
    """-> (this rank's scene view, its probe or None, its pixel share,
    the whole tile order or None)."""
    n = width * height
    n_ray = axis_size(mesh, RAY_AXIS)
    if n % n_ray:
        raise ValueError(f"{n} pixels do not split over {n_ray} ray ranks")
    probe = None
    if SPHERE_AXIS in (mesh.mesh_dim_names or ()):
        if backend == "fused":
            raise ValueError("the fused backend needs the whole sphere "
                             "axis: a mesh with a spheres dim takes "
                             "backends torch and cuda")
        probe = functools.partial(probe_sphere_sharded, mesh=mesh,
                                  backend=backend)
    dev = scene.device
    if backend == "fused":
        order = pixel = tile_pixels(width, height, dev)
    else:
        order, pixel = None, torch.arange(n, dtype=torch.int64, device=dev)
    share = n // n_ray
    k = axis_index(mesh, RAY_AXIS)
    return (shard_scene(scene, mesh), probe,
            pixel[k * share:(k + 1) * share], order)


def _image(color_sum, width: int, height: int, order):
    if order is not None:
        return untile_image(color_sum, width, height, order)
    return color_sum.reshape(height, width, 3)


def render_pass_sharded(scene: Scene, camera: Camera, *, mesh: DeviceMesh,
                        width: int, height: int, spp: int,
                        sample_start: int = 0, seed: int = 0,
                        max_bounces: int = 5, backend: str = "torch",
                        ray_chunk: Optional[int] = None,
                        shading: str = "path", lights: tuple = (),
                        exact_argmin: bool = False,
                        cull_secondary: bool = False, regen: bool = False):
    """One progressive pass, sharded over the mesh; every rank calls it
    with the whole scene. -> (image_sum [H,W,3], the whole image on every
    rank, rays_cast int summed over "rays"). The same pass as
    ``models/path_tracer.render_pass``, pixel for pixel: each rank renders
    its share of the pixel order. Lambert+shadow takes its lights' data
    from the whole scene (a sphere shard may not hold a light's row). A
    "spheres" dim is refused on "fused". exact_argmin and cull_secondary
    change nothing, as in ``render_pass``."""
    del exact_argmin, cull_secondary
    local, probe, pixel, order = _plan(scene, mesh, width, height, backend)
    light_data = (scene_light_data(scene, lights)
                  if shading == "lambert_shadow" else None)
    color_sum, rays = render_pixels(
        local, camera, pixel, width=width, height=height, spp=spp,
        sample_start=sample_start, seed=seed, max_bounces=max_bounces,
        backend=backend, ray_chunk=ray_chunk, shading=shading,
        lights=lights, regen=regen, probe_fn=probe, light_data=light_data)
    color_sum = _GatherRays.apply(color_sum, mesh)
    total = torch.tensor(int(rays), dtype=torch.int64,
                         device=color_sum.device)
    dist.all_reduce(total, group=mesh.get_group(RAY_AXIS))
    return _image(color_sum, width, height, order), int(total)
