"""Counter-based per-ray RNG, bit-equal to ``tpu_ray/core/rng.py``.

Every draw is a pure function of (seed, pixel, sample, bounce, slot): the
one-round PCG output permutation applied as a stateless u32 hash. PyTorch on
the CPU has no uint32 ``+`` or ``>>``, so u32 values ride in int64 tensors
masked to 32 bits; every product below stays under 2**63.

Draw-slot convention per ray (bounce field, slot field):
  bounce 0, slot 4,5    : pixel jitter x, y (primary ray only)
  bounce b, slot 0,1,2  : diffuse scatter direction x, y, z
  bounce b, slot 3      : dielectric reflectance test
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

MIX_PIXEL = 0x9E3779B1
MIX_SAMPLE = 0x85EBCA6B
MIX_BOUNCE = 0x632BE59B
MIX_SLOT = 0xC2B2AE35

_INV_2_32 = np.float32(1.0 / 4294967296.0)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """u32 -> u32 (int64 carriers):
    state = x * 747796405 + 2891336453
    word  = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
    out   = (word >> 22) ^ word
    """
    state = (x * 747796405 + 2891336453) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def pixel_hash(seed: int, pixel: torch.Tensor) -> torch.Tensor:
    """The per-(pixel, seed) half of ray_base (the regen state's h1 row)."""
    return pcg_hash(((pixel.long() * MIX_PIXEL) & MASK32)
                    ^ (int(seed) & MASK32))


def sample_base(h1: torch.Tensor, sample) -> torch.Tensor:
    """The stream base of ``sample`` (int or int tensor) from pixel_hash."""
    return pcg_hash((h1 + (sample * MIX_SAMPLE & MASK32)) & MASK32)


def ray_base(seed: int, pixel: torch.Tensor, sample) -> torch.Tensor:
    """Per-(pixel, sample) stream base. pixel: int tensor; sample: int or
    int tensor."""
    return sample_base(pixel_hash(seed, pixel), sample)


def draw_u32(base: torch.Tensor, bounce, slot: int) -> torch.Tensor:
    """One u32 draw for (stream base, bounce, slot); bounce is an int or an
    integer tensor."""
    slot_term = (int(slot) * MIX_SLOT) & MASK32
    bounce_term = (bounce * MIX_BOUNCE) & MASK32
    return pcg_hash((base + bounce_term + slot_term) & MASK32)


def u32_to_uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """u32 -> f32 uniform in [lo, hi): f32(u) * ((hi-lo)/2^32) + lo."""
    scale = float(np.float32(hi - lo) * _INV_2_32)
    return u.to(torch.float32) * scale + float(np.float32(lo))


def draw_uniform(base, bounce, slot: int, lo: float, hi: float):
    return u32_to_uniform(draw_u32(base, bounce, slot), lo, hi)


def u32_to_bits(u: torch.Tensor) -> torch.Tensor:
    """int64-carried u32 -> the f32 tensor with the same 32 bits (the
    state layout keeps u32 channels bitcast into f32 rows)."""
    signed = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return signed.to(torch.int32).view(torch.float32)


def bits_to_u32(f: torch.Tensor) -> torch.Tensor:
    """Inverse of u32_to_bits: f32 bits -> int64-carried u32."""
    return f.contiguous().view(torch.int32).to(torch.int64) & MASK32
