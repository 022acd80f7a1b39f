"""Differentiable rendering: pixel gradients + inverse-rendering training.

Port of ``tpu_ray/grad``. Gradients flow w.r.t. sphere centres, radii,
materials and camera pose through the O(R) payload recompute only, never
through the O(R*N) search, with the discrete choices (winner,
refract-vs-reflect) held fixed by the counter RNG. ``render_mean_sharded``
waits for the ``torch.distributed`` slice (ROADMAP.md queue A).
"""

from tpu_ray_torch.grad.fit import TrainState, make_train_step
from tpu_ray_torch.grad.render_grad import image_mse, render_mean

__all__ = [
    "image_mse",
    "render_mean",
    "TrainState",
    "make_train_step",
]
