"""ctypes binding + on-demand build of the native C++ oracle.

``csrc/oracle.cpp`` is the compiled counterpart of ``cpu_oracle.py`` (same
algorithm, same f32 op order, same counter RNG): ~1000x faster, so the
card's routes are held against it at full scene size. It is host code: g++
(``-O2 -ffp-contract=off``, no FMA contraction, keeping results
bit-comparable with NumPy) builds it on first use into ``_build/``, beside
the CUDA kernels' library.

The library's file name carries a digest of the source and the flags, so a
finished library is never rewritten: each process compiles into a file of
its own and moves it into place with ``os.replace``. Processes that build at
once (test workers, say) each end with a whole library. A failed build
raises with g++'s output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Tuple

import numpy as np

from tpu_ray_torch.core.scene import Scene
from tpu_ray_torch.oracle.cpu_oracle import host

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "oracle.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O2", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17",
             "-pthread"]

_f32p = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = [
    _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,           # scene arrays
    ctypes.c_int, ctypes.c_int,                         # n, use_sky
    _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,    # triangle soup
    ctypes.c_int,                                       # n_tris
    _f32p, _f32p,                                       # cam_pos, look_at
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # W, H, spp
    ctypes.c_int, ctypes.c_uint32, ctypes.c_int,        # start, seed, mb
    ctypes.c_int,                                       # n_threads
    _f32p,                                              # out_image
]

_lock = threading.Lock()
_lib = None
# the last build of this process: seconds, whether it compiled, the path
build_info: dict = {}


def lib_path(build_dir: str = BUILD_DIR) -> str:
    """The library's path for this source and these flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir, f"liboracle-{h.hexdigest()[:16]}.so")


def build(build_dir: str = BUILD_DIR) -> str:
    """Compile the library unless it is present -> its path."""
    lib = lib_path(build_dir)
    if os.path.exists(lib):
        build_info.update(seconds=0.0, cached=True, path=lib)
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH: the native oracle "
                                "cannot be built")
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, *GXX_FLAGS, SRC, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      path=lib)
    return lib


def bind(path: str) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its C signature."""
    lib = ctypes.CDLL(path)
    # oracle_render_pass_basis takes the camera basis where the other
    # takes the target
    for fn in (lib.oracle_render_pass, lib.oracle_render_pass_basis):
        fn.restype = ctypes.c_uint64
        fn.argtypes = _ARGTYPES
    return lib


def load() -> ctypes.CDLL:
    """The bound library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
    return _lib


def native_available() -> bool:
    """Whether the library can be had here: False only where there is no
    g++; a build that fails raises with g++'s output."""
    try:
        load()
    except FileNotFoundError:
        return False
    return True


class NativeOracle:
    """Same API as CpuOracle, backed by the C++ library. ``n_threads`` 0
    takes every hardware thread."""

    def __init__(self, scene: Scene, n_threads: int = 0):
        self._arrays = {
            name: np.ascontiguousarray(host(getattr(scene, name)))
            for name in ("center", "radius", "albedo", "emissive",
                         "specular", "ior")
        }
        self.n = int(scene.n_pad)
        self.use_sky = bool(scene.use_sky)
        self.m = 0
        self._tri_arrays = None
        if scene.tris is not None:
            t = scene.tris
            self._tri_arrays = [
                np.ascontiguousarray(host(x))
                for x in (t.v0, t.e1, t.e2, t.albedo, t.emissive,
                          t.specular, t.ior)]
            self.m = int(t.n_pad)
        self.n_threads = n_threads
        self._lib = load()

    def render_pass(self, camera_position, look_at, width: int, height: int,
                    spp: int = 1, sample_start: int = 0, seed: int = 0,
                    max_bounces: int = 5,
                    basis=None) -> Tuple[np.ndarray, int]:
        """-> (image_sum [H,W,3] f32 summed over spp, total rays cast).

        ``basis`` (cam_x, cam_y, cam_z, e.g. ``Camera.basis()[:3]``) gives
        the camera's basis in place of the oracle's own, which it builds
        from the position and target with reciprocal roots: the port's
        camera divides, and the two can differ in the last bit."""
        pos = np.ascontiguousarray(host(camera_position))
        if basis is None:
            render = self._lib.oracle_render_pass
            tgt = np.ascontiguousarray(host(look_at))
        else:
            render = self._lib.oracle_render_pass_basis
            tgt = np.ascontiguousarray(np.stack([host(v) for v in basis]))
            if tgt.shape != (3, 3):
                raise ValueError(f"basis: three 3-vectors, got {tgt.shape}")
        out = np.zeros((height, width, 3), np.float32)

        def p(a):
            return a.ctypes.data_as(_f32p)

        a = self._arrays
        if self._tri_arrays is not None:
            tp = [p(x) for x in self._tri_arrays]
        else:
            tp = [_f32p()] * 7
        rays = render(
            p(a["center"]), p(a["radius"]), p(a["albedo"]), p(a["emissive"]),
            p(a["specular"]), p(a["ior"]), self.n, int(self.use_sky),
            *tp, self.m,
            p(pos), p(tgt), width, height, spp, sample_start,
            seed & 0xFFFFFFFF, max_bounces, self.n_threads, p(out))
        return out, int(rays)
