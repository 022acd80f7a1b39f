"""Non-path shading modes: flat and Lambertian + shadow rays.

Port of ``tpu_ray/ops/shading_modes.py``. These are BASELINE.json configs
1 and 2 ("single-sphere + ground, flat shading"; "16-sphere scene,
Lambertian shading + shadow rays"): the standard simpler estimators on the
path tracer's probe (search + payload), so every eager backend gets them.

Lambert+shadow: for each emissive sphere (a "light"), one shadow probe
from the hit point toward the light centre; the point is lit by that
light iff the nearest hit along the shadow ray IS the light sphere.
Contribution = albedo * emissive_light * max(0, n . l_hat) * visibility,
plus the surface's own emissive term.

probe_fn(scene, origins, directions) -> ``ops/intersect.Payload`` of the
nearest hit over the spheres and the scene's triangles
(``models/path_tracer.probe``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu_ray_torch.core.scene import Scene
from tpu_ray_torch.ops.shade import sky_color
from tpu_ray_torch.ops.vec import dot, normalize_eps


def scene_light_indices(scene: Scene) -> Tuple[int, ...]:
    """Host-side: the global indices of the emissive (light) spheres."""
    lit = (scene.emissive != 0).any(dim=1)
    return tuple(int(i) for i in torch.nonzero(lit).flatten().tolist())


def scene_light_data(scene: Scene, lights: Tuple[int, ...]):
    """(light centres [L,3], light emissives [L,3]) gathered from the
    scene, so their gradients reach the light spheres' leaves."""
    idx = torch.tensor(list(lights), dtype=torch.int64, device=scene.device)
    return scene.center[idx], scene.emissive[idx]


def _miss(scene: Scene, directions):
    return sky_color(directions) if scene.use_sky else torch.zeros_like(
        directions)


def trace_flat(scene: Scene, origins, directions, probe_fn):
    """Primary-visibility shading: albedo + emissive of the first hit.
    -> (color [R,3], rays_cast [R] int64): exactly 1 ray per sample."""
    p = probe_fn(scene, origins, directions)
    color = torch.where(p.hit[..., None], p.albedo + p.emissive,
                        _miss(scene, directions))
    return color, torch.ones(origins.shape[0], dtype=torch.int64,
                             device=origins.device)


def trace_lambert_shadow(scene: Scene, origins, directions, probe_fn,
                         lights: Tuple[int, ...], light_data=None):
    """Lambertian direct lighting with one shadow ray per light.

    -> (color [R,3], rays_cast [R] int64): 1 primary + len(lights) shadow
    rays per sample that hits a surface (a miss casts only the primary).
    light_data: (centres [L,3], emissives [L,3]) from scene_light_data;
    None gathers it from ``scene``."""
    if light_data is None:
        light_data = scene_light_data(scene, lights)
    light_centers, light_emissives = light_data

    p = probe_fn(scene, origins, directions)
    hit = p.hit
    n = normalize_eps(p.normal_raw)
    n = torch.where(p.inside[..., None], -n, n)

    color = p.emissive
    rays = torch.ones(origins.shape[0], dtype=torch.int64,
                      device=origins.device)
    for k, li in enumerate(lights):
        ldir = normalize_eps(light_centers[k][None, :] - p.next_origin)
        sp = probe_fn(scene, p.next_origin, ldir)
        visible = sp.hit & (sp.idx == li) & hit
        lam = torch.clamp_min(dot(n, ldir), 0.0)
        contrib = p.albedo * light_emissives[k][None, :] * lam[..., None]
        color = color + torch.where(visible[..., None], contrib, 0.0)
        rays = rays + hit
    color = torch.where(hit[..., None], color, _miss(scene, directions))
    return color, rays
