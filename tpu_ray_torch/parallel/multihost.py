"""Process-group start-up for sharded runs (port of
``tpu_ray/parallel/multihost.py``).

The port runs SPMD over processes: one rank a GPU, launched by
``torchrun`` (or any launcher that sets its variables), every rank running
the same entry point. ``ensure_initialized`` joins the process group from
``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or from explicit arguments, with the
``nccl`` backend on the card and ``gloo`` on the CPU; in a bare single
process it does nothing, so the same entry points run everywhere:

    torchrun --nproc_per_node=N -m tpu_ray_torch.cli render --mesh N ...
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def check_device_type(device_type: str) -> None:
    """Raise unless device_type is "cpu", or "cuda" with a card to run on:
    a group or mesh asked for on the card never falls back to the CPU."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_type 'cuda': no CUDA device is available to this "
            "process; pass device_type='cpu' for a gloo group on the CPU")


def ensure_initialized(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       device_type: str = "cuda") -> bool:
    """Join the process group when the run is multi-process; else no-op.

    Returns True iff the group has more than one rank. Explicit arguments
    (``init_method`` such as ``"tcp://localhost:<port>"``, ``world_size``,
    ``rank``) or ``WORLD_SIZE`` in the environment start the group;
    otherwise a bare single process returns False and starts nothing.
    device_type ("cuda", the default, or "cpu" by name) picks the backend:
    ``nccl`` for "cuda", whose rank then takes the card ``LOCAL_RANK`` (its
    rank when unset), ``gloo`` for "cpu"; "cuda" without a card raises
    (``check_device_type``) before any group is started."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and world_size is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    check_device_type(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1
