"""Scene system: padded SoA sphere scenes (with an optional triangle soup)
and their procedural builders.

Port of ``tpu_ray/core/scene.py``. The builders run on the host in numpy,
bit-faithful to the reference's PCG-seeded construction; ``Scene`` is a
dataclass of torch tensors on one device. Padding spheres keep radius 0,
which can never be hit (``dsq < r*r`` is false for r = 0), so kernels run
on padded arrays with no edge cases. The 128-sphere padding of the JAX
package is kept so the arrays compare 1:1. A scene's triangles
(``core/trimesh.Triangles``) follow the spheres in one primitive id space:
sphere i has id i, triangle j has id n_pad + j.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpu_ray_torch.core.refpcg import RefPcg32
from tpu_ray_torch.core.trimesh import (TRI_LEAVES, Triangles, icosphere,
                                        load_obj, merge, pack_triangles,
                                        quad, triangles_from_numpy)

WORLD_SCALE = np.float32(1.0 / 16.0)  # reference main.cpp:56
F32_EPS = np.float32(1e-4)            # reference base.h:889
F32_MAX = np.float32(1e30)            # reference base.h:891
PI32 = np.float32(3.14159265358979323846)

SPHERE_PAD = 128

# the trainable sphere leaves, in the JAX Scene's names
SCENE_LEAVES = ("center", "radius", "albedo", "emissive", "specular", "ior")
# the triangle leaves as scene leaves: "tris.<name>" (the JAX pytree path)
TRI_SCENE_LEAVES = tuple(f"tris.{k}" for k in TRI_LEAVES)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Padded SoA sphere scene; every array has leading dim n_pad.

    center[N,3], radius[N], albedo[N,3], emissive[N,3], specular[N], ior[N]
    (ior 0 => diffuse/specular, else dielectric), look_at[3]: all f32;
    tris: the triangle soup, or None for a sphere scene.
    """

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor
    emissive: torch.Tensor
    specular: torch.Tensor
    ior: torch.Tensor
    look_at: torch.Tensor
    tris: Optional[Triangles] = None
    use_sky: bool = False
    n_real: int = 0
    default_distance: float = 1.0
    default_x_angle: float = 0.0
    default_y_height: float = 0.0

    @property
    def n_pad(self) -> int:
        return self.center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    @property
    def leaves(self) -> tuple:
        """The names of the scene's trainable leaves: the sphere leaves,
        then the triangle leaves when the scene has triangles."""
        return SCENE_LEAVES + (TRI_SCENE_LEAVES if self.tris is not None
                               else ())

    def leaf(self, name: str) -> torch.Tensor:
        """The tensor of leaf ``name`` (``"tris.v0"`` etc. for triangles)."""
        if name.startswith("tris."):
            return getattr(self.tris, name[5:])
        return getattr(self, name)


class SceneBuilder:
    """Accumulates spheres host-side, then pads + packs into a Scene
    (``add`` in world units; ``build`` pads with radius-0 spheres)."""

    def __init__(self):
        self.centers, self.radii = [], []
        self.albedos, self.emissives, self.speculars, self.iors = [], [], [], []

    def add(self, center, radius, albedo, specular=0.0, ior=0.0, emissive=(0, 0, 0),
            world_scale: bool = True):
        # reference CreateScalarSphere (main.cpp:57-71)
        c = np.asarray(center, np.float32)
        r = np.float32(radius)
        if world_scale:
            c = c * WORLD_SCALE
            r = r * WORLD_SCALE
        self.centers.append(c)
        self.radii.append(r)
        self.albedos.append(np.asarray(albedo, np.float32))
        em = np.asarray(emissive, np.float32)
        if em.ndim == 0:
            em = np.full(3, em, np.float32)
        self.emissives.append(em)
        self.speculars.append(np.float32(specular))
        self.iors.append(np.float32(ior))

    def build(self, look_at, use_sky: bool, default_distance: float,
              default_x_angle: float, default_y_height: float,
              pad_to: int = SPHERE_PAD, truncate: int | None = None,
              device="cuda") -> Scene:
        if truncate is not None:
            for rows in (self.centers, self.radii, self.albedos,
                         self.emissives, self.speculars, self.iors):
                del rows[truncate:]
        n = len(self.centers)
        n_pad = max(pad_to, ((n + pad_to - 1) // pad_to) * pad_to)

        def pack(rows, shape):
            out = np.zeros((n_pad,) + shape, np.float32)
            if n:
                out[:n] = (np.stack(rows) if shape
                           else np.asarray(rows, np.float32))
            return out

        arrays = dict(
            center=pack(self.centers, (3,)),
            radius=pack(self.radii, ()),
            albedo=pack(self.albedos, (3,)),
            emissive=pack(self.emissives, (3,)),
            specular=pack(self.speculars, ()),
            ior=pack(self.iors, ()),
            look_at=np.asarray(look_at, np.float32),
        )
        return scene_from_numpy(
            arrays, use_sky=use_sky, n_real=n,
            default_distance=float(default_distance),
            default_x_angle=float(default_x_angle),
            default_y_height=float(default_y_height), device=device)


def scene_from_numpy(d: Dict[str, np.ndarray], device="cuda",
                     requires_grad: bool = False, tri_n_real=None,
                     **static) -> Scene:
    """Scene from numpy arrays (the JAX Scene's fields, e.g. ``{k:
    np.asarray(getattr(jax_scene, k))}``, and, for a triangle scene, its
    ``tris`` fields under ``"tris.<name>"``) plus its static fields
    (use_sky, n_real, default_distance, default_x_angle,
    default_y_height; ``tri_n_real``: the real triangles, all of them when
    None). ``requires_grad`` makes every sphere and triangle leaf
    trainable."""
    def t(a, grad=False):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=grad)
    tris = None
    if "tris.v0" in d:
        arrays = {k: d[f"tris.{k}"] for k in TRI_LEAVES}
        n = len(arrays["v0"]) if tri_n_real is None else tri_n_real
        tris = triangles_from_numpy(arrays, n, device=device,
                                    requires_grad=requires_grad)
    return Scene(**{k: t(d[k], requires_grad) for k in SCENE_LEAVES},
                 look_at=t(d["look_at"]), tris=tris, **static)


def scene_to_numpy(scene: Scene, grad: bool = False) -> Dict[str, np.ndarray]:
    """The scene's leaves (or, with ``grad``, their ``.grad``, zeros where
    none was accumulated) as numpy arrays under the JAX leaf names
    (triangle leaves as ``"tris.<name>"``)."""
    out = {}
    for k in scene.leaves:
        v = scene.leaf(k)
        if grad:
            v = v.grad if v.grad is not None else torch.zeros_like(v)
        out[k] = v.detach().cpu().numpy()
    return out


def trainable_scene(scene: Scene, names=None) -> Scene:
    """A copy of ``scene`` whose leaves in ``names`` (default: every leaf,
    ``Scene.leaves``) are fresh tensors with ``requires_grad`` (the others
    are detached copies)."""
    names = scene.leaves if names is None else tuple(names)

    def fresh(k):
        return scene.leaf(k).detach().clone().requires_grad_(k in names)
    tris = scene.tris
    if tris is not None:
        tris = dataclasses.replace(tris, **{
            k: fresh(f"tris.{k}") for k in TRI_LEAVES})
    return dataclasses.replace(
        scene, tris=tris, **{k: fresh(k) for k in SCENE_LEAVES})


def make_rgb_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """RGB-glass scene: ground + glass sphere + 3 emissive RGB spheres.

    Reference InitRGBSphereScene (main.cpp:171-191).
    """
    b = SceneBuilder()
    b.add((0.0, -256.0 - 2.0, -15.0), 256.0, (0.2, 0.2, 0.2))
    b.add((0.0, 0.0, -10.0), 2.0, (1.0, 1.0, 1.0), ior=1.5)
    b.add((-4.0, 1.0, -15.0), 1.5, (1.0, 0.0, 0.0), emissive=(8.0, 0.0, 0.0))
    b.add((0.0, 1.0, -15.0), 1.5, (1.0, 0.0, 0.0), emissive=(0.0, 8.0, 0.0))
    b.add((4.0, 1.0, -15.0), 1.5, (1.0, 0.0, 0.0), emissive=(0.0, 0.0, 8.0))
    return b.build(
        look_at=b.centers[1],
        use_sky=False,
        default_distance=16.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(3.0),
        default_y_height=4.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )


def _normalize_f32(v: np.ndarray) -> np.ndarray:
    # reference v3::Normalize (x64_math.h:234-245): exact sqrt + divide,
    # zeroed when length^2 <= 1e-4.
    lsq = np.float32(np.dot(v.astype(np.float32), v.astype(np.float32)))
    if not lsq > F32_EPS:
        return np.zeros(3, np.float32)
    return (v / np.float32(np.sqrt(lsq))).astype(np.float32)


def make_randomized_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """256 randomized spheres grown outward from 3 anchors.

    Reference InitRandomizedSphereScene (main.cpp:96-167), seed main.cpp:107.
    """
    rng = RefPcg32(0x29D7A0A514F22432)
    n_spheres = 256

    # 28 random materials (main.cpp:110-131)
    materials = []
    for _ in range(28):
        color = np.array([
            rng.random_float(0.15, 1.0),
            rng.random_float(0.1, 0.75),
            rng.random_float(0.15, 1.0),
        ], np.float32)
        emissive = np.zeros(3, np.float32)
        specular = np.float32(0.0)
        if rng.random_float(0.0, 1.0) < 0.125:
            emissive = rng.random_float(2.0, 5.0) * color
        else:
            if rng.random_float(0.0, 1.0) < 0.65:
                specular = np.float32(1.0)
        materials.append((color, emissive, specular))

    centers = np.zeros((n_spheres, 3), np.float32)
    radii = np.zeros(n_spheres, np.float32)
    mat_of = np.zeros(n_spheres, np.int32)

    # 3 fixed anchor spheres share one radius draw (main.cpp:133-137)
    radius0 = rng.random_float(2.0, 8.0)
    for i, pos in enumerate([(1.0, 0.0, 0.0), (8.0, -1.0, 8.0), (-20.0, -4.0, -20.0)]):
        centers[i] = pos
        radii[i] = radius0
        mat_of[i] = 0

    # growth loop (main.cpp:139-155)
    for i in range(3, n_spheres):
        vec = np.array([rng.random_float(), rng.random_float(), rng.random_float()],
                       np.float32)
        nvec = _normalize_f32(vec)
        prev_r = radii[i - 3]
        prev_p = centers[i - 3]
        radius = rng.random_float(1.0, 4.0)
        dist = np.float32(rng.random_float(1.0, 8.0) + radius + prev_r)
        centers[i] = (prev_p + nvec * dist).astype(np.float32)
        radii[i] = radius
        mat_of[i] = i % 28

    # world-scale applied after generation (main.cpp:156-162)
    centers *= WORLD_SCALE
    radii *= WORLD_SCALE

    b = SceneBuilder()
    for i in range(n_spheres):
        color, emissive, specular = materials[mat_of[i]]
        b.add(centers[i], radii[i], color, specular=specular, ior=0.0,
              emissive=emissive, world_scale=False)
    return b.build(
        look_at=np.array([2.0, 0.0, 2.0], np.float32) * WORLD_SCALE,
        use_sky=False,
        default_distance=48.0 * WORLD_SCALE,
        default_x_angle=(PI32 * np.float32(2.65)) / np.float64(2.0),
        default_y_height=0.0,
        pad_to=pad_to,
        device=device,
    )


def make_rtweekend_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """'Ray Tracing in One Weekend' scene: 4 fixed + 22x22 grid = 482 spheres.

    Reference InitRTWeekendSphereScene (main.cpp:196-268), seed main.cpp:219.
    """
    rng = RefPcg32(0xCD46749A57ACB371)
    b = SceneBuilder()
    b.add((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    b.add((0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), ior=1.5)
    b.add((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), specular=1.0)

    anchors = [np.array(a, np.float32) for a in
               [(4.0, 0.2, 0.0), (0.0, 0.2, 0.0), (-4.0, 0.2, 0.0)]]

    for i in range(-11, 11):
        for j in range(-11, 11):
            m = rng.random_float(0.0, 1.0)
            # rejection-sampled placement (main.cpp:229-236); note the
            # reference jitters with the *default* [-1,1] RandomFloat
            while True:
                center = np.array([
                    np.float32(i) + rng.random_float(),
                    0.2,
                    np.float32(j) + rng.random_float(),
                ], np.float32)
                ok = all(
                    np.float32(np.sqrt(np.float32(np.dot(center - a, center - a)))) > 0.9
                    for a in anchors
                )
                if ok:
                    break
            specular, ior = 0.0, 0.0
            if m < 0.8:
                color = (rng.random_float(0.0, 1.0), rng.random_float(0.0, 1.0),
                         rng.random_float(0.0, 1.0))
            elif m < 0.95:
                color = (rng.random_float(0.0, 1.0), rng.random_float(0.0, 1.0),
                         rng.random_float(0.0, 1.0))
                specular = rng.random_float(0.5, 1.0)
            else:
                color = (1.0, 1.0, 1.0)
                ior = 1.5
            b.add(center, 0.2, color, specular=specular, ior=ior)

    return b.build(
        look_at=b.centers[1],  # assigned pre-pack in reference (main.cpp:266)
        use_sky=True,
        default_distance=12.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(8.0),
        default_y_height=2.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
        # The reference declares RTWeekendSpheres[482] (main.cpp:193) but its
        # generator emits 4 + 22*22 = 488 spheres; the last 6 are written out
        # of bounds and never rendered (ScalarSpheres.Count stays 482). Only
        # the first 482 are part of the rendered scene — match that.
        truncate=482,
    )


def make_single_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """Single sphere + ground "plane" (huge sphere), sky lit.

    BASELINE.json config 1: the minimal CPU-runnable end-to-end scene.
    Not a reference scene; geometry follows the reference's ground-sphere
    idiom (main.cpp:174, a 256-radius sphere as the floor).
    """
    b = SceneBuilder()
    b.add((0.0, -256.0, -10.0), 256.0, (0.5, 0.5, 0.5))
    b.add((0.0, 1.5, -10.0), 1.5, (0.8, 0.3, 0.3))
    return b.build(
        look_at=b.centers[1],
        use_sky=True,
        default_distance=10.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(3.0),
        default_y_height=2.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )


def make_sixteen_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """16 spheres: ground + 2 emissive lights + 13 diffuse/specular ring.

    BASELINE.json config 2: the Lambertian + shadow-ray benchmark scene.
    Deterministic layout (no RNG) so goldens are stable.
    """
    b = SceneBuilder()
    b.add((0.0, -256.0, 0.0), 256.0, (0.45, 0.45, 0.45))
    b.add((0.0, 6.0, 0.0), 1.0, (1.0, 1.0, 1.0), emissive=(12.0, 11.0, 10.0))
    b.add((5.0, 4.0, 5.0), 0.75, (1.0, 1.0, 1.0), emissive=(2.0, 4.0, 8.0))
    for k in range(13):
        ang = 2.0 * float(PI32) * k / 13.0
        r = 3.5
        b.add((r * math.cos(ang), 0.8, r * math.sin(ang)), 0.8,
              ((k % 3 == 0) * 0.7 + 0.2, (k % 3 == 1) * 0.7 + 0.2,
               (k % 3 == 2) * 0.7 + 0.2),
              specular=0.9 if k % 4 == 0 else 0.0)
    return b.build(
        look_at=(0.0, 0.0, 0.0),
        use_sky=False,
        default_distance=14.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(4.0),
        default_y_height=5.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )


def make_sixtyfour_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """64 spheres: ground + 3 lights + 60 in two deterministic rings.

    BASELINE.json config 3's scene (camera-pose + material gradients at
    1024x1024 16spp). Deterministic layout, 3 emissive lights, sky ON —
    the sky gradient gives radiance a smooth dependence on ray direction,
    which is what makes camera-pose gradients non-degenerate (in a purely
    emissive closed scene the pixel integrand is piecewise constant in
    pose and gradients vanish a.e.).
    """
    b = SceneBuilder()
    b.add((0.0, -256.0, 0.0), 256.0, (0.5, 0.5, 0.5))
    b.add((0.0, 7.0, 0.0), 1.2, (1.0, 1.0, 1.0), emissive=(10.0, 10.0, 9.0))
    b.add((6.0, 5.0, 6.0), 0.8, (1.0, 1.0, 1.0), emissive=(8.0, 3.0, 1.0))
    b.add((-6.0, 5.0, -6.0), 0.8, (1.0, 1.0, 1.0), emissive=(1.0, 3.0, 8.0))
    for ring, (rad, n, y, size) in enumerate([(4.0, 24, 0.8, 0.8),
                                              (7.5, 36, 0.6, 0.6)]):
        for k in range(n):
            ang = 2.0 * float(PI32) * k / n + ring * 0.3
            c = ((k * 7) % n) / float(n)
            b.add((rad * math.cos(ang), y, rad * math.sin(ang)), size,
                  (0.25 + 0.7 * c, 0.25 + 0.7 * abs(0.5 - c) * 2.0,
                   0.95 - 0.7 * c),
                  specular=0.85 if k % 5 == 0 else 0.0,
                  ior=1.5 if k % 11 == 3 else 0.0)
    return b.build(
        look_at=(0.0, 0.5 * float(WORLD_SCALE), 0.0),
        use_sky=True,
        default_distance=18.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(4.0),
        default_y_height=6.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )


def make_trimesh_scene(pad_to: int = SPHERE_PAD, subdivisions: int = 4,
                       device="cuda") -> Scene:
    """~10k-triangle scene: two icospheres and a ground quad under the sky,
    plus one glass sphere (mixed primitive types). BASELINE.json config 4.
    subdivisions=4 -> 2 * 20*4^4 = 10240 mesh triangles + 2 ground =
    10242."""
    s = float(WORLD_SCALE)
    v1, f1 = icosphere(subdivisions)
    v2, f2 = icosphere(subdivisions)
    g = 40.0 * s
    verts, faces, colors = merge([
        (v1 * (1.5 * s) + np.array([-1.8 * s, 1.5 * s, 0.0], np.float32),
         f1, (0.8, 0.35, 0.25)),
        (v2 * (1.2 * s) + np.array([2.0 * s, 1.2 * s, -0.8 * s], np.float32),
         f2, (0.3, 0.5, 0.85)),
        (*quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)),
         (0.55, 0.55, 0.55)),
    ])
    tris = pack_triangles(verts, faces, colors, device=device)

    b = SceneBuilder()
    b.add((0.0, 1.0, 2.5), 1.0, (1.0, 1.0, 1.0), ior=1.5)
    scene = b.build(
        look_at=np.array([0.0, 1.2 * s, 0.0], np.float32),
        use_sky=True,
        default_distance=10.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(5.0),
        default_y_height=3.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )
    return dataclasses.replace(scene, tris=tris)


def make_bigmesh_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """~164k-triangle scene (trimesh at subdivisions=6), past
    ``kernels/bounce_step.resident_tables_fit``: every backend renders it
    on the streaming route (the probe route with the listed triangle
    search, K10 on the card, and the sorted-bounce wavefront)."""
    return make_trimesh_scene(pad_to=pad_to, subdivisions=6, device=device)


SCENE_BUILDERS: Dict[str, Callable[..., Scene]] = {
    "rgb": make_rgb_scene,                # reference scene 0
    "randomized": make_randomized_scene,  # reference scene 1
    "rtweekend": make_rtweekend_scene,    # reference scene 2
    "single": make_single_scene,          # BASELINE config 1
    "sixteen": make_sixteen_scene,        # BASELINE config 2
    "sixtyfour": make_sixtyfour_scene,    # BASELINE config 3
    "trimesh": make_trimesh_scene,        # BASELINE config 4 (10k tris)
    "bigmesh": make_bigmesh_scene,        # 164k tris (streaming route)
}

_SCENE_BY_INDEX = ["rgb", "randomized", "rtweekend", "single", "sixteen",
                   "sixtyfour", "trimesh"]


def make_obj_scene(path: str, pad_to: int = SPHERE_PAD,
                   albedo=(0.6, 0.6, 0.6), device="cuda") -> Scene:
    """Scene from a Wavefront OBJ file (``--scene obj:PATH``): the mesh is
    scaled so its longest extent is 2.5 world units, set on a gray ground
    quad under the sky, and framed by the default orbit camera. Per-face
    materials are a uniform albedo. A mesh past
    ``kernels/bounce_step.resident_tables_fit`` renders on the streaming
    route (see ``make_bigmesh_scene``), with a warning that says so."""
    v, f = load_obj(path)
    lo, hi = v.min(axis=0), v.max(axis=0)
    span = float(max(np.max(hi - lo), 1e-6))
    s = float(WORLD_SCALE)
    v = (v - (lo + hi) * 0.5) * (2.5 * s / span)
    v[:, 1] -= v[:, 1].min()
    g = 40.0 * s
    verts, faces, colors = merge([
        (v, f, albedo),
        (*quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)),
         (0.55, 0.55, 0.55)),
    ])
    tris = pack_triangles(verts, faces, colors, device=device)
    from tpu_ray_torch.kernels.bounce_step import resident_tables_fit
    if not resident_tables_fit(pad_to, tris.n_pad):
        warnings.warn(
            f"{path}: {tris.n_pad} (padded) triangles are past the "
            "residency rule; rendering routes to the streaming triangle "
            "search (slower per triangle than the resident routes, but no "
            "table has to fit on chip)", stacklevel=2)
    b = SceneBuilder()
    scene = b.build(
        look_at=np.array([0.0, 1.0 * s, 0.0], np.float32),
        use_sky=True,
        default_distance=8.0 * WORLD_SCALE,
        default_x_angle=PI32 / np.float64(5.0),
        default_y_height=2.5 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )
    return dataclasses.replace(scene, tris=tris)


def make_trilight_scene(pad_to: int = SPHERE_PAD, device="cuda") -> Scene:
    """Small mixed scene for the Lambert+shadow estimator on triangles: an
    emissive sphere (the light) and a diffuse sphere over a resident soup
    (an icosphere and a ground quad, 82 triangles) that is hit, shaded and
    casts shadows. The JAX test suite's ``_tri_light_scene``
    (tests/test_shading_modes.py), built op for op; not one of the named
    scenes of ``make_scene``."""
    s = float(WORLD_SCALE)
    v, f = icosphere(1)
    g = 20.0 * s
    verts, faces, colors = merge([
        (v * (1.2 * s) + np.array([0.0, 1.2 * s, 0.0], np.float32), f,
         (0.7, 0.4, 0.3)),
        (*quad((-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)),
         (0.5, 0.5, 0.5)),
    ])
    tris = pack_triangles(verts, faces, colors, device=device)
    b = SceneBuilder()
    b.add((3.0, 6.0, 2.0), 1.0, (1.0, 1.0, 1.0), emissive=(8.0, 7.5, 7.0))
    b.add((2.2, 0.8, 0.5), 0.8, (0.3, 0.6, 0.4))
    scene = b.build(
        look_at=np.array([0.0, 1.2 * s, 0.0], np.float32),
        use_sky=True,
        default_distance=8.0 * WORLD_SCALE,
        default_x_angle=0.6,
        default_y_height=3.0 * WORLD_SCALE,
        pad_to=pad_to,
        device=device,
    )
    return dataclasses.replace(scene, tris=tris)


def make_scene(name_or_index, pad_to: int = SPHERE_PAD,
               device="cuda") -> Scene:
    if isinstance(name_or_index, int):
        name_or_index = _SCENE_BY_INDEX[name_or_index]
    if name_or_index.startswith("obj:"):
        return make_obj_scene(name_or_index[4:], pad_to=pad_to,
                              device=device)
    return SCENE_BUILDERS[name_or_index](pad_to=pad_to, device=device)
