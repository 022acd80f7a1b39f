"""The benchmark's scenes, built here from their published definitions.

A configuration file names its scene (``"scene": {"kind": ..., ...}``);
``build`` turns that into numpy arrays that the harness hands, the same
bits, to the program and to the plain reference. Nothing here imports the
program: the builders follow the reference renderer's own construction
(SIMD-Ray-Tracer ``main.cpp``, its PCG32 seeded as there) and the repo's
``BASELINE.md`` config 4 for the triangle scene, op for op in f32 numpy.

Arrays (the program's padded layout: spheres padded to a multiple of 128
with radius 0, triangles to a multiple of 128 with e1 = e2 = 0, neither
ever hit):
  center [N,3] radius [N] albedo [N,3] emissive [N,3] specular [N] ior [N]
  look_at [3]; for a triangle scene ``tris.v0``/``e1``/``e2``/``albedo``/
  ``emissive`` [M,3], ``tris.specular``/``tris.ior`` [M].
Static fields: use_sky, n_real, tri_n_real, and the default orbit camera
(distance, x_angle, y_height).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

WORLD_SCALE = np.float32(1.0 / 16.0)   # main.cpp:56
PI32 = np.float32(3.14159265358979323846)
PAD = 128

_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1


class Pcg32:
    """The reference renderer's u32_random_state (base.h:951-997)."""

    def __init__(self, seed: int):
        self.seed = seed & _MASK64

    def random_int(self) -> int:
        old = self.seed
        self.seed = (old * 6364136223846793005 + 1442695040888963407) \
            & _MASK64
        x = ((old >> 32) ^ old) & _MASK32
        r = (old >> 59) & 31
        return ((x >> r) | (x << (32 - r))) & _MASK32 if r else x

    def random_float(self, lo: float = -1.0, hi: float = 1.0) -> np.float32:
        n = self.random_int()
        inv = np.float32((hi - lo) / 4294967295.0)
        return np.float32(np.float32(n) * inv + np.float32(lo))


def _padded(n: int) -> int:
    return max(PAD, -(-n // PAD) * PAD)


def _pack_spheres(rows) -> Dict[str, np.ndarray]:
    """rows: (center, radius, albedo, specular, ior, emissive) in the
    reference's units -> padded sphere arrays in world units."""
    n = len(rows)
    out = {"center": np.zeros((_padded(n), 3), np.float32),
           "radius": np.zeros(_padded(n), np.float32),
           "albedo": np.zeros((_padded(n), 3), np.float32),
           "emissive": np.zeros((_padded(n), 3), np.float32),
           "specular": np.zeros(_padded(n), np.float32),
           "ior": np.zeros(_padded(n), np.float32)}
    for i, (c, r, alb, spec, ior, em) in enumerate(rows):
        out["center"][i] = np.asarray(c, np.float32) * WORLD_SCALE
        out["radius"][i] = np.float32(r) * WORLD_SCALE
        out["albedo"][i] = np.asarray(alb, np.float32)
        out["emissive"][i] = np.asarray(em, np.float32)
        out["specular"][i] = np.float32(spec)
        out["ior"][i] = np.float32(ior)
    return out


def rtweekend() -> Tuple[Dict[str, np.ndarray], dict]:
    """'Ray Tracing in One Weekend': 4 fixed spheres and the 22 x 22 grid
    (InitRTWeekendSphereScene, main.cpp:196-268, PCG seed main.cpp:219).
    The reference declares 482 spheres (main.cpp:193) and renders those,
    though its generator emits 488: the first 482 are kept."""
    rng = Pcg32(0xCD46749A57ACB371)
    none = (0.0, 0.0, 0.0)
    rows = [((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), 0.0, 0.0, none),
            ((0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), 0.0, 1.5, none),
            ((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), 0.0, 0.0, none),
            ((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 1.0, 0.0, none)]
    anchors = [np.array(a, np.float32) for a in
               [(4.0, 0.2, 0.0), (0.0, 0.2, 0.0), (-4.0, 0.2, 0.0)]]
    for i in range(-11, 11):
        for j in range(-11, 11):
            m = rng.random_float(0.0, 1.0)
            while True:   # rejection-sampled placement, main.cpp:229-236
                center = np.array([np.float32(i) + rng.random_float(), 0.2,
                                   np.float32(j) + rng.random_float()],
                                  np.float32)
                if all(np.float32(np.sqrt(np.float32(
                        np.dot(center - a, center - a)))) > 0.9
                       for a in anchors):
                    break
            specular, ior = 0.0, 0.0
            if m < 0.8:
                color = tuple(rng.random_float(0.0, 1.0) for _ in range(3))
            elif m < 0.95:
                color = tuple(rng.random_float(0.0, 1.0) for _ in range(3))
                specular = rng.random_float(0.5, 1.0)
            else:
                color, ior = (1.0, 1.0, 1.0), 1.5
            rows.append((center, 0.2, color, specular, ior, none))
    rows = rows[:482]
    arrays = _pack_spheres(rows)
    arrays["look_at"] = np.asarray(rows[1][0], np.float32) * WORLD_SCALE
    static = dict(use_sky=True, n_real=482, tri_n_real=0,
                  distance=float(12.0 * WORLD_SCALE),
                  x_angle=float(PI32 / np.float64(8.0)),
                  y_height=float(2.0 * WORLD_SCALE))
    return arrays, static


def icosphere(subdivisions: int):
    """Unit icosphere -> (vertices [V,3] f32, faces [F,3]); F = 20 * 4^s."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                      [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                      [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6],
                      [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11],
                      [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        cache: Dict[Tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in cache:
                mid = (vlist[a] + vlist[b]) / 2.0
                mid /= np.linalg.norm(mid)
                cache[key] = len(vlist)
                vlist.append(mid)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)
    return verts.astype(np.float32), faces


def trimesh(subdivisions: int = 4) -> Tuple[Dict[str, np.ndarray], dict]:
    """BASELINE.md config 4: two icospheres (2 x 20 x 4^s triangles) and a
    two-triangle ground quad under the sky, and one glass sphere."""
    s = float(WORLD_SCALE)
    v1, f1 = icosphere(subdivisions)
    v2, f2 = icosphere(subdivisions)
    g = 40.0 * s
    quad_v = np.asarray([(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)],
                        np.float32)
    quad_f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    meshes = [(v1 * (1.5 * s) + np.array([-1.8 * s, 1.5 * s, 0.0],
                                         np.float32), f1, (0.8, 0.35, 0.25)),
              (v2 * (1.2 * s) + np.array([2.0 * s, 1.2 * s, -0.8 * s],
                                         np.float32), f2, (0.3, 0.5, 0.85)),
              (quad_v, quad_f, (0.55, 0.55, 0.55))]
    vs, fs, cols, off = [], [], [], 0
    for v, f, c in meshes:
        vs.append(v)
        fs.append(f + off)
        cols.append(np.broadcast_to(np.asarray(c, np.float32),
                                    (len(f), 3)))
        off += len(v)
    v = np.concatenate(vs).astype(np.float32)
    f = np.concatenate(fs)
    m = len(f)
    mp = _padded(m)
    tris = {k: np.zeros((mp, 3), np.float32)
            for k in ("v0", "e1", "e2", "albedo", "emissive")}
    tris["specular"] = np.zeros(mp, np.float32)
    tris["ior"] = np.zeros(mp, np.float32)
    tris["v0"][:m] = v[f[:, 0]]
    tris["e1"][:m] = v[f[:, 1]] - v[f[:, 0]]
    tris["e2"][:m] = v[f[:, 2]] - v[f[:, 0]]
    tris["albedo"][:m] = np.concatenate(cols)
    none = (0.0, 0.0, 0.0)
    arrays = _pack_spheres([((0.0, 1.0, 2.5), 1.0, (1.0, 1.0, 1.0), 0.0, 1.5,
                             none)])
    arrays["look_at"] = np.array([0.0, 1.2 * s, 0.0], np.float32)
    arrays.update({f"tris.{k}": a for k, a in tris.items()})
    static = dict(use_sky=True, n_real=1, tri_n_real=m,
                  distance=float(10.0 * WORLD_SCALE),
                  x_angle=float(PI32 / np.float64(5.0)),
                  y_height=float(3.0 * WORLD_SCALE))
    return arrays, static


KINDS = {"rtweekend": rtweekend, "trimesh": trimesh}


def build(spec: dict) -> Tuple[Dict[str, np.ndarray], dict]:
    """A configuration's ``scene`` entry -> (arrays, static fields)."""
    args = {k: v for k, v in spec.items() if k != "kind"}
    return KINDS[spec["kind"]](**args)


def orbit(look_at: np.ndarray, static: dict):
    """The default orbit camera's position (main.cpp:776-781), computed
    in f32 on the host: (position [3], look_at [3])."""
    a = np.float32(static["x_angle"])
    dist = np.float32(static["distance"])
    pos = np.array([np.float32(math.cos(a)) * dist, static["y_height"],
                    np.float32(math.sin(a)) * dist], np.float32)
    return (pos + look_at).astype(np.float32), look_at.astype(np.float32)
