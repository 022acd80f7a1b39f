"""Per-bounce scatter and shading math (reference main.cpp:446-481, and
``tpu_ray/ops/shade.py`` op for op).

Emissive add + albedo attenuation, then a Lambertian-ish random bounce
mixed with the specular reflection, or a dielectric refract/reflect with
Schlick reflectance. Every branch is computed for every ray and selected
with ``where``; every untaken branch stays finite.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.ops.vec import dot, normalize_eps, reflect, safe_sqrt


def schlick_reflectance(cos_theta, refraction_index):
    """Schlick approximation (reference main.cpp:292-300)."""
    r0 = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = r0 * r0
    r1 = 1.0 - cos_theta
    r1 = r1 * r1 * r1 * r1 * r1
    return r0 + (1.0 - r0) * r1


def sky_color(direction):
    """Vertical sky gradient (reference main.cpp:434-438)."""
    a = (direction[..., 1] + 1.0) * 0.5
    white = torch.ones(3, dtype=torch.float32, device=direction.device)
    # filled on the device: a tensor made from a host list is a blocking
    # copy to the card at every call
    blue = torch.empty(3, dtype=torch.float32, device=direction.device)
    for i, v in enumerate((0.5, 0.7, 1.0)):
        blue[i].fill_(v)
    return (1.0 - a)[..., None] * white + a[..., None] * blue


def scatter_direction(direction, normal_raw, inside, specular, ior,
                      rand3, rand_reflect):
    """New ray direction after a hit.

    direction [R,3] (unit), normal_raw [R,3], inside [R] bool, specular [R],
    ior [R] (0 => diffuse/specular path), rand3 [R,3] uniform in [-1,1],
    rand_reflect [R] uniform in [0,1].
    """
    normal = normalize_eps(normal_raw)
    # PureBounce uses the unflipped normal (reference main.cpp:453)
    pure = reflect(direction, normal)
    n2 = torch.where(inside[..., None], -normal, normal)

    # diffuse / specular mix (reference main.cpp:460-464)
    rand_unit = normalize_eps(rand3)
    random_bounce = n2 + rand_unit
    spec = specular[..., None]
    d_diffuse = normalize_eps((1.0 - spec) * random_bounce + spec * pure)

    # dielectric (reference main.cpp:465-481)
    ior_safe = torch.where(ior == 0.0, 1.0, ior)
    ri = torch.where(inside, ior_safe, 1.0 / ior_safe)
    cos_theta = torch.clamp_max(dot(-direction, n2), 1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cant_refract = ri * sin_theta > 1.0
    perp = ri[..., None] * (direction + cos_theta[..., None] * n2)
    par = -safe_sqrt(torch.abs(1.0 - dot(perp, perp)))[..., None] * n2
    refracted = normalize_eps(perp + par)
    choose_reflect = (
        cant_refract | (schlick_reflectance(cos_theta, ri) > rand_reflect)
    ) & ~inside
    d_dielectric = torch.where(choose_reflect[..., None], pure, refracted)

    return torch.where((ior == 0.0)[..., None], d_diffuse, d_dielectric)
