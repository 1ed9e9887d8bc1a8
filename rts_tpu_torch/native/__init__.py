"""ctypes bindings for the C++ host geometry runtime (src/rts_native.cpp),
a copy of ``rts_tpu.native``.

Builds the shared library with g++ at first use into
``build/rts_tpu_torch/`` (once per source hash and host CPU, never next
to the source).  Every entry point returns ``None`` when the library is
unavailable (no compiler, or ``RTS_NO_NATIVE`` set in the environment,
which is read at every call), and its callers then take their NumPy
path: the native layer is the fast path for million-triangle host work
(file parsing, icosphere subdivision, Morton ordering, soup flattening),
never a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "rts_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rts_tpu_torch"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


class _Native:
    """The loaded library (one per process) and whether a load was tried."""

    lock = threading.Lock()
    lib = None
    tried = False


def _cpu() -> str:
    """The host CPU's model: ``-march=native`` builds for it, so a library
    built on one CPU is never loaded on another."""
    try:
        with open("/proc/cpuinfo") as fh:
            return next((ln for ln in fh if ln.startswith("model name")), platform.machine())
    except OSError:
        return platform.machine()


def build() -> Path | None:
    """Compile the source with g++ (once per source hash, flags and host
    CPU) and return the library's path, or None if the build fails."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode() + _cpu().encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"librts_native_{tag}.so"
    if out.exists():
        return out
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None
    return out


def _load():
    if os.environ.get("RTS_NO_NATIVE"):
        # diagnostics and bisection: force the pure-NumPy paths
        return None
    with _Native.lock:
        if _Native.lib is not None or _Native.tried:
            return _Native.lib
        _Native.tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i64, i32, f64, ch = (
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p,
        )
        lib.rts_icosphere_counts.argtypes = [ctypes.c_int, i64, i64]
        lib.rts_icosphere_counts.restype = ctypes.c_int
        lib.rts_icosphere.argtypes = [ctypes.c_int] + [ctypes.c_double] * 4 + [f64, i32, f64]
        lib.rts_icosphere.restype = ctypes.c_int
        lib.rts_count_triplets.argtypes = [ch]
        lib.rts_count_triplets.restype = ctypes.c_int64
        lib.rts_load_triplets.argtypes = [ch, ctypes.c_int64, f64]
        lib.rts_load_triplets.restype = ctypes.c_int
        lib.rts_morton_order.argtypes = [f64, ctypes.c_int64, i64]
        lib.rts_morton_order.restype = ctypes.c_int
        lib.rts_flatten.argtypes = [f64, i32, ctypes.c_int64, ctypes.c_void_p, f64]
        lib.rts_flatten.restype = ctypes.c_int
        _Native.lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def icosphere(subdivs: int, radius: float, yaw=0.0, pitch=0.0, roll=0.0):
    """(verts [V,3], tris [T,3], normals [V,3]) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    if lib.rts_icosphere_counts(subdivs, ctypes.byref(nv), ctypes.byref(nt)):
        return None
    verts = np.empty((nv.value, 3))
    tris = np.empty((nt.value, 3), np.int32)
    normals = np.empty((nv.value, 3))
    rc = lib.rts_icosphere(
        subdivs, float(radius), float(yaw), float(pitch), float(roll),
        _ptr(verts, ctypes.c_double), _ptr(tris, ctypes.c_int32), _ptr(normals, ctypes.c_double),
    )
    return None if rc else (verts, tris, normals)


def load_triplets(path: str):
    """[N, 3] float64 from a whitespace/comma text file, or None."""
    lib = _load()
    if lib is None:
        return None
    n = lib.rts_count_triplets(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, 3))
    if lib.rts_load_triplets(path.encode(), n, _ptr(out, ctypes.c_double)):
        raise IOError(f"parse error in {path}")
    return out


def morton_order(tri_verts: np.ndarray):
    """Morton permutation of [T,3,3] triangle soup, or None."""
    lib = _load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts, np.float64)
    if tv.ndim != 3 or tv.shape[1:] != (3, 3):
        raise ValueError(f"tri_verts must be [T, 3, 3], got {tv.shape}")
    t = tv.shape[0]
    perm = np.empty(t, np.int64)
    lib.rts_morton_order(_ptr(tv, ctypes.c_double), t, _ptr(perm, ctypes.c_int64))
    return perm


def flatten(verts: np.ndarray, tris: np.ndarray, perm: np.ndarray | None = None):
    """Gather corners [T,3,3] (optionally permuted), or None."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    tr = np.ascontiguousarray(tris, np.int32)
    t = tr.shape[0]
    if v.ndim != 2 or v.shape[1] != 3 or tr.ndim != 2 or tr.shape[1] != 3:
        raise ValueError(f"verts must be [V, 3] and tris [T, 3], got {v.shape} and {tr.shape}")
    if t and (tr.min() < 0 or tr.max() >= v.shape[0]):
        raise ValueError("a triangle indexes past the vertices")
    p = None
    if perm is not None:
        p = np.ascontiguousarray(perm, np.int64)
        if p.shape != (t,) or (t and (p.min() < 0 or p.max() >= t)):
            raise ValueError("perm must be a [T] permutation of the triangles")
    out = np.empty((t, 3, 3))
    lib.rts_flatten(
        _ptr(v, ctypes.c_double),
        _ptr(tr, ctypes.c_int32),
        t,
        p.ctypes.data_as(ctypes.c_void_p) if p is not None else None,
        _ptr(out, ctypes.c_double),
    )
    return out
