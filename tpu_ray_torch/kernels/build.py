"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

One nvcc call compiles every source into ``_build/libtpu_ray_torch_kernels.so``
with a plain ``extern "C"`` interface and no PyTorch headers (seconds, where
a ``torch.utils.cpp_extension`` build takes minutes), bound with ctypes.
The library is rebuilt when the hash of the sources or flags changes.
Nothing here runs at import: the first kernel launch builds and loads.

``-fmad=false`` keeps nvcc from contracting a*b+c into FMAs, so the kernels
repeat the plain PyTorch versions' f32 op sequences exactly and their
checks can be tight. A later speed change may revisit it.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_NAME = "libtpu_ray_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
# every entry point returns cudaGetLastError() after its launch; the caller
# launches under ``torch.cuda.device`` of its tensors
SIGNATURES = {
    # center, radius, n, origin, direction, r, slices, keys, t_out,
    # idx_out, stream
    "trt_sphere_nearest_hit": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    # r, n -> K1's slices on the current device (a count; a negative
    # return is a CUDA error)
    "trt_sphere_slices": [_I, _I],
    # tri, m, origin, direction, r, slices, keys, t_out, idx_out, stream
    "trt_tri_nearest_hit": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P],
    # r, m -> K7's triangle slices on the current device (a count; a
    # negative return is a CUDA error)
    "trt_tri_slices": [_I, _I],
    # tri, m, boxes, n_tiles, origin, direction, alive, r, t_out, idx_out,
    # lists_only, stats, stream
    "trt_tri_stream": [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P],
    # state, r, cam13, table, n, tri, m, boxes, n_tiles, stats, steps,
    # use_sky, max_bounces, width, height, film_w, film_h, stream
    "trt_regen_steps": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                        _I, _I, _F, _F, _P],
    # as trt_regen_steps, then rec, chk, t_end, seg, stream
    "trt_regen_steps_record": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I,
                               _I, _I, _I, _I, _F, _F, _P, _P, _P, _I, _P],
    # state, r, cam13, table, n, boxes, starts, n_tiles, gboxes, gstarts,
    # n_groups, o_lim, stats, steps, use_sky, max_bounces, width, height,
    # film_w, film_h, rec, chk, t_end, seg, stream
    "trt_regen_sph": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _F, _P, _I,
                      _I, _I, _I, _I, _F, _F, _P, _P, _P, _I, _P],
    # d_state, r, cam13, table, n, n_tri, rec, chk, t_end, steps, seg,
    # use_sky, max_bounces, width, height, film_w, film_h, part, touched,
    # part_cam, d_table, d_cam, stats, stream
    "trt_regen_bwd": [_P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                      _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P],
    # r, n -> rows of trt_regen_bwd's partials (returns a count, not an
    # error)
    "trt_regen_bwd_parts": [_I, _I],
    # n, out[6]: K3's registers, local bytes, blocks an SM, threads, shared
    # bytes, SMs
    "trt_regen_bwd_info": [_I, _P],
    # state, out, r, table, n_sph, bounce, mask, n_tiles, block_n, boxes,
    # starts, n_stiles, gboxes, gstarts, n_groups, o_lim, tri, m, use_sky,
    # stats, idx_out, stream
    "trt_bounce_fwd": [_P, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P,
                       _P, _I, _F, _P, _I, _I, _P, _P, _P],
    # state, out, r, table, n_sph, tri, m, boxes, n_tiles, block_m,
    # bounce, use_sky, stats, idx_out, stream
    "trt_bounce_fwd_list": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                            _P, _P, _P],
    # state, out, r, table, n_sph, idx, bounce, use_sky, stream
    "trt_bounce_replay": [_P, _P, _I, _P, _I, _P, _I, _I, _P],
    # state, idx, table, n, n_sph, d_state, r, bounce, use_sky, part,
    # touched, d_table, stats, stream
    "trt_bounce_bwd": [_P, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                       _P],
    # r, n -> rows of trt_bounce_bwd's partials; n -> threads of its
    # blocks (each returns a count, not an error)
    "trt_bounce_bwd_parts": [_I, _I],
    "trt_bounce_bwd_threads": [_I],
    # rows, r, cam13, table, n_sph, tri, m, boxes, n_tiles, sboxes,
    # sstarts, n_stiles, sgboxes, sgstarts, n_sgroups, o_lim, lidx, ldat,
    # n_lights, spp, s0, use_sky, width, height, film_w, film_h, stats, out,
    # stream
    "trt_simple_trace": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P,
                         _P, _I, _F, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                         _P, _P, _P],
    # keys, perm, g, r, w, n, d_table, skeys, svals, sout, stream (K11)
    "trt_gather_rows_bwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    # r -> rows of trt_gather_rows_bwd's scratch (a count, not an error)
    "trt_gather_rows_scratch": [_I],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> str:
    """Compile the library unless an up-to-date one is present -> its path.
    Records the build's seconds and nvcc's output in ``build_info``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib + ".sha256"
    digest = _digest()
    if os.path.exists(lib) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                build_info.update(seconds=0.0, cached=True, log="")
                return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    srcs = [p for p in _sources() if p.endswith(".cu")]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    with open(stamp, "w") as f:
        f.write(digest)
    build_info.update(seconds=secs, cached=False,
                      log=proc.stdout + proc.stderr)
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, and on ``device``)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
