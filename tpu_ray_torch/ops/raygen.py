"""Per-pixel jittered primary rays (reference main.cpp:378-385), op for op
with ``tpu_ray/ops/raygen.py``.

Film coords in [-1,1] with a per-sample jitter in [-0.5, 0.5] drawn from
the counter RNG (slots 4/5 at bounce 0). ``film_rays`` is shared with the
regen kernel's plain version, whose in-lane regeneration must repeat this
f32 op sequence exactly; the CUDA kernel in ``csrc/regen.cu`` does too.
Divisions by the film size use a tensor divisor: CUDA PyTorch turns a
division by a Python scalar into a multiply by its reciprocal.
"""
from __future__ import annotations

import torch

from tpu_ray_torch.core import rng
from tpu_ray_torch.core.camera import Camera, film_extent
from tpu_ray_torch.ops.vec import normalize_eps
from tpu_ray_torch.utils.metrics import to_device

JITTER_SLOT_X = 4
JITTER_SLOT_Y = 5


def film_offsets(ax, ay, base, width: int, height: int):
    """Pixel coords (ax, ay [R] f32) + stream base [R] -> the jittered
    film point's offsets (fx, fy) [R] along cam_x and cam_y. They do not
    depend on the camera, so the regen backward recomputes them."""
    jx = rng.draw_uniform(base, 0, JITTER_SLOT_X, -0.5, 0.5)
    jy = rng.draw_uniform(base, 0, JITTER_SLOT_Y, -0.5, 0.5)
    w = to_device(float(width), ax.device, torch.float32)
    h = to_device(float(height), ax.device, torch.float32)
    film_x = -1.0 + torch.div((ax + jx) * 2.0, w)
    film_y = -1.0 + torch.div((ay + jy) * 2.0, h)
    film_w, film_h = film_extent(width, height)
    return film_x * float(film_w) * 0.5, film_y * float(film_h) * 0.5


def film_rays(ax, ay, base, width: int, height: int, position,
              film_center, cam_x, cam_y):
    """Pixel coords (ax, ay [R] f32) + stream base [R] -> unit directions
    [R,3] through the jittered film point. position/film_center/cam_x/
    cam_y: [3] f32."""
    fx, fy = film_offsets(ax, ay, base, width, height)
    film_p = (film_center + fx[..., None] * cam_x) + fy[..., None] * cam_y
    return normalize_eps(film_p - position)


def camera_rays(camera: Camera, width: int, height: int, pixel, sample_idx,
                seed: int):
    """-> (origins [R,3], directions [R,3], stream_base [R] u32 in int64).

    pixel [R] int flat pixel indices (row-major, y*width + x; y=0 is the
    film bottom, the reference's GL-convention framebuffer)."""
    base = rng.ray_base(seed, pixel, sample_idx)
    ax = (pixel % width).to(torch.float32)
    ay = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    cam_x, cam_y, _, film_center = camera.basis()
    directions = film_rays(ax, ay, base, width, height, camera.position,
                           film_center, cam_x, cam_y)
    origins = camera.position.expand_as(directions).contiguous()
    return origins, directions, base
