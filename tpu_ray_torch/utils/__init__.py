"""Host-side utilities: image IO, checkpointing, metrics and profiling
(port of ``tpu_ray/utils``)."""

from tpu_ray_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from tpu_ray_torch.utils.metrics import MetricsLogger, StepTimer
from tpu_ray_torch.utils.png import write_png

__all__ = [
    "write_png",
    "save_checkpoint",
    "load_checkpoint",
    "MetricsLogger",
    "StepTimer",
]
