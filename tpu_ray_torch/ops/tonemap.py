"""Tone mapping and 8-bit packing (reference LinearToSRGB main.cpp:312-329,
which ships the sqrt approximation of the sRGB curve; ColorFromV4
main.cpp:340-346 truncates like C)."""
from __future__ import annotations

import torch

SRGB_CUTOFF = 0.0031308


def linear_to_srgb(linear, exact: bool = False):
    l = torch.clamp(linear, 0.0, 1.0)
    if exact:
        high = 1.055 * torch.pow(torch.clamp_min(l, SRGB_CUTOFF),
                                 1.0 / 2.4) - 0.055
    else:
        high = torch.sqrt(torch.clamp_min(l, SRGB_CUTOFF))
    return torch.where(l < SRGB_CUTOFF, l * 12.92, high)


def pack_rgba8(srgb):
    """[..., 3] f32 in [0,1] -> [..., 4] u8 (alpha 255), truncating like C."""
    rgb = (torch.clamp(srgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full(rgb.shape[:-1] + (1,), 255, dtype=torch.uint8,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
