"""Small vector helpers over trailing dim-3 axes.

The epsilon-zeroing rule of v3::Normalize (reference x64_math.h:234-245:
the result is 0 when |v|^2 <= 1e-4) is kept because the render math relies
on it. Dot products are written out as ((x + y) + z) so the CUDA kernels
can repeat the same f32 op sequence.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.core.scene import F32_EPS


def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def sqrt_f32(x):
    """The correctly rounded f32 sqrt, as the CUDA kernels' sqrtf gives it.
    PyTorch's CPU sqrt misses it in the last bit on some inputs (and on
    more of them in a process's first call), so the root is taken in f64,
    which rounds back to the same f32 on every device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def safe_sqrt(x):
    """sqrt with zero (not NaN) for x <= 0."""
    pos = x > 0
    return torch.where(pos, sqrt_f32(torch.where(pos, x, 1.0)), 0.0)


def normalize_eps(v):
    """Reference v3::Normalize: v/|v|, but 0 when |v|^2 <= F32_EPS."""
    lsq = dot(v, v)[..., None]
    ok = lsq > float(F32_EPS)
    inv = 1.0 / sqrt_f32(torch.where(ok, lsq, 1.0))
    return torch.where(ok, v * inv, 0.0)


def reflect(d, n):
    """Mirror reflection (reference main.cpp:453)."""
    return d - 2.0 * dot(d, n)[..., None] * n
