"""Build and load the CUDA kernels; count their launches.

All sources in ``gsplat_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, in parallel) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use, once per process, into
``gsplat_tpu_torch/_build/`` (listed in ``.gitignore``); the library's name
carries a hash of the sources and flags, so an edited source is rebuilt.

Every C entry point takes its pointers and the CUDA stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code.

``launches`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (never the plain-PyTorch CPU path), the radix sort's also per
call site of the main path, and the rasterizers' and the segment sum's
also in packed mode (``name/packed``; the rest ran in exact mode): a run
can show that the main path went through each kernel. A CUDA graph's
capture launches nothing: ``recording()`` takes back what the wrappers
counted while it captured, and each replay adds it (``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]  # per-source compile flags; the link adds -shared

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (every function returns the cudaError_t).
SIGNATURES = {
    # out, records, offsets_ext, num_cols, num_records, width, capped, stream
    "gs_segment_expand": [_P, _P, _P, _I, _I, _I, _I, _P],
    # keys_in, keys_out, vals_out, pairs_tmp, scratch, n, passes, plan
    # (host ints: shift, bits per pass), stream
    "gs_radix_sort": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    # out, attrs, splat_gid, tile_start, tile_count, num_tiles,
    # num_tiles_x, bg (a device float), packed, stream
    "gs_rasterize_forward": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    # grads, attrs, splat_gid, tile_start, tile_count, out, d_tiles,
    # num_tiles, num_tiles_x, bg (a device float), scale_u, scale_v, packed,
    # pack_grads, stream
    "gs_rasterize_backward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                              ctypes.c_float, ctypes.c_float, _I, _I, _P],
    # out, rows, pair_slot, pair_start, n, stream
    "gs_segment_sum": [_P, _P, _P, _P, _I, _P],
    # out, words, pair_slot, pair_start, n, stream
    "gs_segment_sum_packed": [_P, _P, _P, _P, _I, _P],
    # out, perm, p, stream
    "gs_inverse_permutation": [_P, _P, _I, _P],
}

launches = {
    "segment_expand": 0, "radix_sort": 0, "radix_sort/tile": 0, "radix_sort/morton": 0,
    "rasterize_forward": 0, "rasterize_forward/packed": 0, "rasterize_backward": 0,
    "rasterize_backward/packed": 0, "segment_sum": 0, "segment_sum/packed": 0,
    "inverse_permutation": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of this process's build (ptxas -v)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def recording():
    """For a CUDA graph's capture: yields a dict that, on exit, holds the
    launches the wrappers counted inside the block, which are taken back
    from ``launches`` (a capture launches nothing; a replay launches them
    all, and adds them with ``add_launches``)."""
    before = dict(launches)
    counted: dict[str, int] = {}
    try:
        yield counted
    finally:
        for name in launches:
            counted[name] = launches[name] - before[name]
            launches[name] = before[name]


def add_launches(counted: dict) -> None:
    for name, n in counted.items():
        launches[name] += n


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build kernels")
    return found


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = _digest(sources + sorted(CSRC.glob("*.cuh")))
        lib_path = BUILD_DIR / f"libgsplat_kernels_{digest}.so"
        if not lib_path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{digest}.{os.getpid()}"
            objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
            # One nvcc per source, all started together, then one link.
            procs = [
                (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                            for src, obj in zip(sources, objs))
            ]
            logs = [(cmd, proc.communicate(timeout=900)[0], proc.returncode)
                    for cmd, proc in procs]
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            if all(rc == 0 for _, _, rc in logs):
                proc = subprocess.run(link, capture_output=True, text=True, timeout=300)
                logs.append((link, proc.stdout + proc.stderr, proc.returncode))
            build_log = "".join(out for _, out, _ in logs)
            for obj in objs:
                obj.unlink(missing_ok=True)
            for cmd, out, rc in logs:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
            os.replace(tmp, lib_path)  # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
