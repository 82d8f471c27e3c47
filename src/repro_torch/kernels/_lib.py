"""Build, load and count the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The library is built at first use into ``build/repro_torch/``
under the repository root, in a directory keyed by a hash of the sources
and flags, one ``nvcc`` per source started together.  Nothing here runs
at import: the CPU tests import every module.

Each wrapper adds one to its entry of :data:`launch_counts` where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts", "lib",
           "build", "call", "check", "x_stride"]

#: Every kernel the library holds, by wrapper name.
KERNELS = ("ell_spmv", "seg_psum", "seg_fixup", "split_combine",
           "tile_contrib", "split_psum", "tile_walk_spmv")

launch_counts = {name: 0 for name in KERNELS}

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("spmv_ell.cu", "spmv_seg.cu", "spmv_split.cu", "spmv_tile.cu")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures: (symbol, argtypes).  Pointers and the stream are void*.
_SIGNATURES = {
    "rt_ell_spmv": (_P, _P, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _I, _I, _I,
                    _I, _P, _P),
    "rt_seg_psum": (_P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _P, _P),
    "rt_seg_fixup": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "rt_split_psum": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "rt_split_combine": (_P, _P, _I, _I, _I, _I, _P, _P),
    "rt_tile_spmv": (_P, _P, _P, _P, _LL, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _P, _P),
    "rt_tile_walk_spmv": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
}

_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the port's "
                       "kernels are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has not been built yet;
    returns its path.  Records the build time and the ``ptxas`` report in
    :data:`build_info`."""
    out = BUILD_ROOT / _digest() / "librepro_torch_kernels.so"
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"--- {src}\n{text}")
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        so = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-o", so,
                               *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(so, out)            # atomic: concurrent builds agree
    build_info.update(seconds=time.perf_counter() - t0,
                      ptxas="\n".join(logs))
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for sym, argtypes in _SIGNATURES.items():
            fn = getattr(handle, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def call(name: str, symbol: str, device, *args) -> None:
    """Launch ``symbol`` on ``device`` (the device of the tensors whose
    pointers are in ``args``), on that device's current stream, and count
    it under ``name``; raises with the CUDA error code if the launch was
    refused.  The C launchers run on whatever device is current, so the
    launch is made with ``device`` current."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), symbol)(*args, stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    launch_counts[name] += 1


def check(device, **tensors) -> None:
    """Raise unless every ``name=(tensor, dtype, ndim)`` lies on ``device``
    with that dtype and rank and is contiguous (what the kernels take)."""
    for name, (t, dtype, ndim) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{ndim} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def x_stride(x) -> int:
    """Elements between two shards' x buffers: 0 when every shard reads one
    shared vector (x is (1, B, Lx))."""
    return 0 if x.shape[0] == 1 else x.shape[1] * x.shape[2]
