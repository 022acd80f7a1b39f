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


def default_device_type() -> str:
    """"cuda" where there is a card, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def ensure_initialized(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       device_type: Optional[str] = None) -> bool:
    """Join the process group when the run is multi-process; else no-op.

    Returns True iff the group has more than one rank. Explicit arguments
    (``init_method`` such as ``"tcp://localhost:<port>"``, ``world_size``,
    ``rank``) or ``WORLD_SIZE`` in the environment start the group;
    otherwise a bare single process returns False and starts nothing.
    device_type ("cuda" or "cpu", default: "cuda" where there is a card)
    picks the backend: ``nccl`` for "cuda", whose rank then takes the card
    ``LOCAL_RANK`` (its rank when unset), ``gloo`` for "cpu"."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and world_size is None and "WORLD_SIZE" not in env:
        return False
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    device_type = device_type or default_device_type()
    if device_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return world_size > 1
