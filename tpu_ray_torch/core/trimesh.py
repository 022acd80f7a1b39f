"""Triangle meshes: padded SoA triangle soups and their host-side builders.

Port of ``tpu_ray/core/trimesh.py``. Triangles are stored pre-differenced
(v0, e1 = v1 - v0, e2 = v2 - v0), the form the Möller-Trumbore test
consumes, and padded to a multiple of TRI_PAD with degenerate triangles
(e1 = e2 = 0, so det = 0 and they are never hit), as radius-0 spheres pad
a sphere table. The builders run in numpy exactly as the JAX package's do;
``Triangles`` holds torch tensors on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

TRI_PAD = 128

# the trainable triangle leaves, in the JAX Triangles' names
TRI_LEAVES = ("v0", "e1", "e2", "albedo", "emissive", "specular", "ior")


@dataclasses.dataclass(frozen=True)
class Triangles:
    """Padded SoA triangle soup with per-triangle materials: v0, e1, e2,
    albedo, emissive [M,3] and specular, ior [M], all f32 (ior 0 =>
    diffuse/specular, else dielectric). n_real triangles are real, the
    rest degenerate padding."""

    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    albedo: torch.Tensor
    emissive: torch.Tensor
    specular: torch.Tensor
    ior: torch.Tensor
    n_real: int = 0

    @property
    def n_pad(self) -> int:
        return self.v0.shape[0]


def triangles_from_numpy(d: Dict[str, np.ndarray], n_real: int,
                         device="cuda",
                         requires_grad: bool = False) -> Triangles:
    """Triangles from numpy arrays under the leaf names
    (``requires_grad`` makes every leaf trainable)."""
    return Triangles(**{
        k: torch.tensor(np.asarray(d[k], np.float32), device=device,
                        requires_grad=requires_grad)
        for k in TRI_LEAVES}, n_real=int(n_real))


def pack_triangles(vertices: np.ndarray, faces: np.ndarray, albedo,
                   emissive=(0.0, 0.0, 0.0), specular=0.0, ior=0.0,
                   pad_to: int = TRI_PAD, device="cuda") -> Triangles:
    """vertices [V,3] + faces [M,3] -> padded Triangles. ``albedo`` and
    ``emissive`` may be [3] (uniform) or [M,3] (per face)."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int64)
    m = len(f)
    m_pad = max(pad_to, ((m + pad_to - 1) // pad_to) * pad_to)

    def field(x, shape):
        a = np.asarray(x, np.float32)
        if a.ndim < len(shape) + 1:
            a = np.broadcast_to(a, (m,) + shape)
        out = np.zeros((m_pad,) + shape, np.float32)
        out[:m] = a
        return out

    v0 = np.zeros((m_pad, 3), np.float32)
    e1 = np.zeros((m_pad, 3), np.float32)
    e2 = np.zeros((m_pad, 3), np.float32)
    v0[:m] = v[f[:, 0]]
    e1[:m] = v[f[:, 1]] - v[f[:, 0]]
    e2[:m] = v[f[:, 2]] - v[f[:, 0]]
    arrays = dict(v0=v0, e1=e1, e2=e2, albedo=field(albedo, (3,)),
                  emissive=field(emissive, (3,)),
                  specular=field(specular, ()), ior=field(ior, ()))
    return triangles_from_numpy(arrays, m, device=device)


def icosphere(subdivisions: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere -> (vertices [V,3] f32, faces [M,3]); M = 20 * 4^s."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

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


def quad(p0, p1, p2, p3) -> Tuple[np.ndarray, np.ndarray]:
    """Two-triangle quad from 4 corner points (counter-clockwise)."""
    v = np.asarray([p0, p1, p2, p3], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return v, f


def merge(meshes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[(verts, faces, albedo_rgb), ...] -> (verts, faces, per-face
    albedo)."""
    vs, fs, cols = [], [], []
    off = 0
    for v, f, c in meshes:
        vs.append(v)
        fs.append(f + off)
        cols.append(np.broadcast_to(np.asarray(c, np.float32),
                                    (len(f), 3)).copy())
        off += len(v)
    return (np.concatenate(vs), np.concatenate(fs), np.concatenate(cols))


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ reader -> (vertices [V,3] f32, faces [F,3]
    i64): ``v`` and ``f`` lines in all four index forms (v, v/vt, v/vt/vn,
    v//vn), negative (relative) indices, polygons fan-triangulated.
    Normals, texture coordinates and materials are ignored."""
    verts: list = []
    faces: list = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"no triangles in OBJ file {path!r}")
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    if f.min() < 0 or f.max() >= len(v):
        raise ValueError(f"face index out of range in {path!r}")
    return v, f
