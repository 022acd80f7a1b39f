"""The counter RNG in NumPy, for the oracles' per-pixel loops.

A copy of the NumPy branch of ``tpu_ray/core/rng.py`` (``xp=numpy``), bit
for bit, and bit-equal to ``tpu_ray_torch/core/rng.py``, whose draws ride
in int64 torch tensors: too slow a call for a loop over pixels. Every draw
is a pure function of (seed, pixel, sample, bounce, slot): the one-round
PCG output permutation applied as a stateless u32 hash.

Draw-slot convention per ray (bounce field, slot field):
  bounce 0, slot 4,5    : pixel jitter x, y (primary ray only)
  bounce b, slot 0,1,2  : diffuse scatter direction x, y, z
  bounce b, slot 3      : dielectric reflectance test
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32

MIX_PIXEL = 0x9E3779B1
MIX_SAMPLE = 0x85EBCA6B
MIX_BOUNCE = 0x632BE59B
MIX_SLOT = 0xC2B2AE35

_INV_2_32 = np.float32(1.0 / 4294967296.0)


def pcg_hash(x):
    """u32 -> u32:
    state = x * 747796405 + 2891336453
    word  = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
    out   = (word >> 22) ^ word
    """
    x = x.astype(_U32) if hasattr(x, "astype") else _U32(x)
    with np.errstate(over="ignore"):  # u32 wraparound is the point
        state = x * _U32(747796405) + _U32(2891336453)
        shift = (state >> _U32(28)) + _U32(4)
        word = ((state >> shift) ^ state) * _U32(277803737)
        return (word >> _U32(22)) ^ word


def ray_base(seed: int, pixel, sample):
    """Per-(pixel, sample) stream base; ``pixel`` and ``sample`` are numpy
    arrays (0-d in the oracle's loop), ``seed`` a Python int."""
    with np.errstate(over="ignore"):
        h = pcg_hash(pixel.astype(_U32) * _U32(MIX_PIXEL)
                     ^ _U32(int(seed) & 0xFFFFFFFF))
        return pcg_hash(h + sample.astype(_U32) * _U32(MIX_SAMPLE))


def draw_u32(base, bounce, slot: int):
    """One u32 draw for (stream base, bounce, slot). The scalar mixing
    products are reduced mod 2^32 in Python, which keeps NumPy's
    scalar-overflow warnings out of the loop."""
    slot_term = _U32((int(slot) * MIX_SLOT) & 0xFFFFFFFF)
    if isinstance(bounce, (int, np.integer)):
        bounce_term = _U32((int(bounce) * MIX_BOUNCE) & 0xFFFFFFFF)
    else:
        bounce_term = bounce.astype(_U32) * _U32(MIX_BOUNCE)
    with np.errstate(over="ignore"):
        return pcg_hash(base + bounce_term + slot_term)


def u32_to_uniform(u, lo: float, hi: float):
    """u32 -> f32 uniform in [lo, hi): f32(u) * ((hi-lo)/2^32) + lo."""
    scale = np.float32(hi - lo) * _INV_2_32
    return u.astype(np.float32) * scale + np.float32(lo)


def draw_uniform(base, bounce, slot: int, lo: float, hi: float):
    return u32_to_uniform(draw_u32(base, bounce, slot), lo, hi)
