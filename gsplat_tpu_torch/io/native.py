"""ctypes bindings for the port's C++ host runtime (port of
``gsplat_tpu/io/native.py``): a points3D.bin parser, an OpenMP kd-tree KNN
mean distance and a binary PLY writer (``native/gsplat_native.cpp``).

The library is built at first use, once per process, with
``g++ -O3 -march=native -fPIC -fopenmp -std=c++17 -shared`` (the ``g++``
on ``PATH``; ``$CXX`` is not read, since a host may point it at a compiler
built without OpenMP) into ``gsplat_tpu_torch/_build/``, named by a hash of
the source, the flags and what ``-march=native`` selects on the host, so
an edited source, or a build directory carried to another machine, is
rebuilt. A build writes a temporary file and renames it into place, so
processes that build at once agree. A failed build raises with the
compiler's output; nothing falls back to the plain versions (scipy's
cKDTree, the Python reader and writer), which stay for the tests to hold
these against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "gsplat_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]

_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None


def _compiler() -> str | None:
    return shutil.which("g++")


@functools.lru_cache(maxsize=None)
def _target(cxx: str | None) -> bytes:
    """What ``-march=native`` means to the compiler on this host (its CPU
    and every instruction-set flag), so that a build directory carried to
    another machine is not loaded there."""
    if cxx is None:
        return b""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, timeout=60)
    return proc.stdout


def library_path() -> Path:
    """Where the library for this source, these flags and this host's
    ``-march=native`` target lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_target(_compiler()))
    return BUILD_DIR / f"libgsplat_native_{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gsplat_count_points3d.restype = ctypes.c_longlong
    lib.gsplat_count_points3d.argtypes = [ctypes.c_char_p]
    lib.gsplat_parse_points3d.restype = ctypes.c_longlong
    lib.gsplat_parse_points3d.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.gsplat_knn_mean_dist.restype = ctypes.c_int
    lib.gsplat_knn_mean_dist.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gsplat_save_ply.restype = ctypes.c_int
    lib.gsplat_save_ply.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the library; idempotent. Raises
    RuntimeError when no compiler is found or the build fails."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        path = library_path()
        if not path.is_file():
            cxx = _compiler()
            if cxx is None:
                raise RuntimeError(f"no g++ on PATH; cannot build {SOURCE.name}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)  # atomic: concurrent builds agree
        _loaded = _bind(ctypes.CDLL(str(path)))
        return _loaded


def available() -> bool:
    """Whether the library is loaded or can be built here (a compiler is
    on the path). A build that fails raises from the functions below."""
    return _loaded is not None or library_path().is_file() or _compiler() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rows(arr, n: int, cols: int | None, name: str) -> np.ndarray:
    """``arr`` as a C-contiguous float32 (n, cols) array ((n,) for None),
    raising before a pointer to it reaches the library."""
    arr = np.ascontiguousarray(arr, np.float32)
    shape = (n,) if cols is None else (n, cols)
    if arr.shape != shape:
        raise ValueError(f"{name} has shape {arr.shape}, expected {shape}")
    return arr


def parse_points3d(path: str | Path):
    """Parse a COLMAP points3D.bin: (xyz f64 (N, 3), rgb u8 (N, 3), error
    f64 (N,), ids u64 (N,)), in file order."""
    lib = build()
    n = lib.gsplat_count_points3d(str(path).encode())
    if n < 0:
        raise OSError(f"Could not open file {path}")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    ids = np.empty((n,), np.uint64)
    got = lib.gsplat_parse_points3d(
        str(path).encode(), n,
        _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
        _ptr(err, ctypes.c_double), _ptr(ids, ctypes.c_uint64),
    )
    if got != n:
        raise OSError(f"Corrupt points3D file {path}")
    return xyz, rgb, err, ids


def knn_mean_dist(xyz: np.ndarray, k: int = 3) -> np.ndarray:
    """(N,) float32 mean distance to each point's k nearest neighbours,
    itself excluded by index (a duplicate of it counts, at 0); fewer where
    the cloud has fewer, and 0.01 for a point with none."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lib = build()
    xyz = np.ascontiguousarray(xyz, np.float64)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz has shape {xyz.shape}, expected (N, 3)")
    out = np.empty((xyz.shape[0],), np.float32)
    rc = lib.gsplat_knn_mean_dist(
        _ptr(xyz, ctypes.c_double), xyz.shape[0], k, _ptr(out, ctypes.c_float)
    )
    if rc != 0:
        raise RuntimeError(f"knn_mean_dist failed on {xyz.shape[0]} points")
    return out


def save_ply(path, xyz, rgb, opacity, scale, quat, sh=None) -> None:
    """Write the binary PLY that ``io/ply.py::save_ply`` writes, byte for
    byte: quaternions normalized (a zero one as is), ``sh`` flattened to
    ``f_rest_*`` per row."""
    lib = build()
    n = xyz.shape[0]
    xyz = _rows(xyz, n, 3, "xyz")
    rgb = _rows(rgb, n, 3, "rgb")
    opacity = _rows(np.reshape(opacity, -1), n, None, "opacity")
    scale = _rows(scale, n, 3, "scale")
    norm = np.linalg.norm(quat, axis=1, keepdims=True)
    quat = _rows(quat / np.where(norm > 0, norm, 1.0), n, 4, "quat")
    num_sh = 0
    sh_ptr = _ptr(np.empty(0, np.float32), ctypes.c_float)
    if sh is not None:
        sh = np.ascontiguousarray(sh, np.float32).reshape(n, -1)
        num_sh = sh.shape[1]
        sh_ptr = _ptr(sh, ctypes.c_float)
    rc = lib.gsplat_save_ply(
        str(path).encode(), n, num_sh,
        _ptr(xyz, ctypes.c_float), _ptr(rgb, ctypes.c_float),
        _ptr(opacity, ctypes.c_float), _ptr(scale, ctypes.c_float),
        _ptr(quat, ctypes.c_float), sh_ptr,
    )
    if rc != 0:
        raise OSError(f"Could not write {path}")
