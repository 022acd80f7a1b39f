"""Progressive accumulation (reference main.cpp:484-489, 805-806): the
running mean ``mean' = (mean*n + batch_sum) / (n + k)`` over sample
batches."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AccumState:
    mean: torch.Tensor  # [H,W,3] f32 running mean of linear radiance
    samples: int        # samples accumulated so far

    @staticmethod
    def zeros(height: int, width: int, device="cuda") -> "AccumState":
        return AccumState(
            mean=torch.zeros((height, width, 3), dtype=torch.float32,
                             device=device),
            samples=0)


def accumulate(state: AccumState, batch_sum, batch_samples: int) -> AccumState:
    """Fold a batch of ``batch_samples`` sample sums into the running mean."""
    # imported here: tpu_ray_torch.utils imports this module
    from tpu_ray_torch.utils.metrics import to_device
    n = float(state.samples)
    total = to_device(n + batch_samples, batch_sum.device, torch.float32)
    mean = torch.div(state.mean * n + batch_sum, total)
    return AccumState(mean=mean, samples=state.samples + batch_samples)
