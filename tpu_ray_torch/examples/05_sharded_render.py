#!/usr/bin/env python
"""Sharded rendering over a device mesh. The PyTorch counterpart of the
JAX package's examples/05_sharded_render.py.

The reference distributes 32x32 pixel tiles over OS threads with a
lock-free work queue (reference wasm/wasm.cpp:604-694). Across GPUs the
same decomposition is SPMD over processes on ``torch.distributed``, one
rank a card: a ``DeviceMesh`` with the ray wavefront statically sharded
over a "rays" dim (the workload is uniform, so even sharding beats
stealing) and the scene replicated. Every rank calls
``render_pass_sharded`` with the whole scene; it renders the rank's share
of the pixels, all-gathers the colour rows and sums the rays-cast count,
the only collectives on the hot path.

An optional second "spheres" dim shards the primitive arrays instead
(``shard_scene`` gives each rank its slice): each rank computes partial
nearest-hit minima over its sphere slice and the winners come from an
all-gather (tensor parallelism over the primitive axis). Pass --mesh 2x2
etc. to exercise it; it takes backends torch and cuda (the default, the
CUDA search kernel K1), since "fused" needs the whole sphere axis.

Launch one process a card:
  torchrun --nproc_per_node=N tpu_ray_torch/examples/05_sharded_render.py --mesh N
or on the CPU, with gloo:
  torchrun --nproc_per_node=2 \\
      tpu_ray_torch/examples/05_sharded_render.py --mesh 2 --device cpu
A bare process gets a mesh of one rank. Sharded output is BIT-IDENTICAL
to the single-process render (tests/test_torch_parallel.py): sharding is
a pure throughput knob.
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="rtweekend")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=184)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--mesh", default="",
                    help="'4' = 4-way ray sharding, '2x2' = rays x spheres; "
                         "default: every rank of the launch on the ray dim")
    ap.add_argument("--backend", default="cuda",
                    choices=["torch", "cuda", "fused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="sharded.png")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpu_ray_torch import default_camera, make_scene
    from tpu_ray_torch.ops.tonemap import linear_to_srgb, pack_rgba8
    from tpu_ray_torch.parallel import make_mesh, render_pass_sharded
    from tpu_ray_torch.utils.png import write_png

    shape = (tuple(int(x) for x in args.mesh.split("x")) if args.mesh
             else None)
    # joins the launch's process group (nccl on "cuda", each rank on the
    # card LOCAL_RANK; gloo on "cpu")
    mesh = make_mesh(shape, device_type=args.device)
    rank = dist.get_rank()
    if rank == 0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} {args.device} rank(s)")

    # "cuda" is the rank's own card (make_mesh set it)
    scene = make_scene(args.scene, device=args.device)
    camera = default_camera(scene)

    image_sum, rays = render_pass_sharded(
        scene, camera, mesh=mesh, width=args.width, height=args.height,
        spp=args.spp, sample_start=0, backend=args.backend)
    image = image_sum / args.spp
    if rank == 0:
        write_png(args.out,
                  pack_rgba8(linear_to_srgb(image)).flip(0).cpu().numpy())
        print(f"{int(rays):,} rays cast -> {args.out}")
    return image


if __name__ == "__main__":
    # run as a script: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    main()
