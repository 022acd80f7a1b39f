"""Host-side PCG32 used for deterministic procedural scene generation.

The reference generates its scenes with a 64-bit-state PCG32
(`u32_random_state`, reference base.h:951-997) seeded with fixed constants
(reference main.cpp:107, main.cpp:219). Reproducing that stream bit-exactly on
the host lets our scenes match the reference's scenes exactly, which is the
foundation of forward-parity testing (SURVEY.md §2 C12).

This is *host* RNG only — the per-ray render-time RNG is the counter-based
scheme in core/rng.py (order-independent, shardable).
"""
from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1

_PCG_MULT = 6364136223846793005
_PCG_INC = 1442695040888963407


class RefPcg32:
    """Bit-exact re-implementation of the reference's u32_random_state PCG.

    state update: seed = seed * 6364136223846793005 + 1442695040888963407
    output:       rotr32(hi32(old) ^ lo32(old), old >> 59)
    (reference base.h:954-963)
    """

    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = seed & _MASK64

    def random_int(self) -> int:
        old = self.seed
        self.seed = (old * _PCG_MULT + _PCG_INC) & _MASK64
        x = ((old >> 32) ^ old) & _MASK32
        r = (old >> 59) & 31
        return ((x >> r) | (x << (32 - r))) & _MASK32 if r else x

    def random_float(self, lo: float = -1.0, hi: float = 1.0) -> np.float32:
        """f32 in [lo, hi] matching reference base.h:983-989 float math.

        inv = f32((hi - lo) / (2^32 - 1))   # computed in f64, stored f32
        out = f32(n) * inv + lo             # f32 multiply, f32 add
        """
        n = self.random_int()
        inv = np.float32((hi - lo) / 4294967295.0)
        return np.float32(np.float32(n) * inv + np.float32(lo))
