"""On-demand C tick kernel for the Emu simulator (optional fast path).

The port's copy of ``repro.core._emu_cext``.  Compiles ``_emu_tick.c``
with the system C compiler into a content-hashed shared object under
``build/repro_torch/emu/`` at the repository root (gitignored, like the
CUDA library of :mod:`repro_torch.kernels._lib`), falling back to a
``repro_torch-emu`` directory under the temporary directory, and binds it
through :mod:`ctypes`.  The JAX package builds its own copy elsewhere, so
neither package ever loads the other's binary.  No Python package is
installed or required; if anything in the chain is missing (no compiler,
read-only build directory, exotic platform), the caller falls back to the
pure-numpy engine, which is bitwise-equal.

Set ``REPRO_EMU_DISABLE_CEXT=1`` to force the fallback (used by tests to
exercise the numpy path explicitly).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from numpy.ctypeslib import ndpointer

_SRC = os.path.join(os.path.dirname(__file__), "_emu_tick.c")
_kernel = None
_load_attempted = False

_i64 = ctypes.c_int64
_f64 = ctypes.c_double


def _arr(dtype):
    return ndpointer(dtype=dtype, flags="C_CONTIGUOUS")


#: Where the shared object is built: ``build/repro_torch/emu`` under the
#: repository root.
BUILD_DIR = str(Path(__file__).resolve().parents[3] / "build" / "repro_torch"
                / "emu")


def _compile(src_path: str) -> str | None:
    """Build the shared object (content-addressed, atomic rename)."""
    with open(src_path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    for cand_dir in (BUILD_DIR,
                     os.path.join(tempfile.gettempdir(), "repro_torch-emu")):
        so_path = os.path.join(cand_dir, f"_emu_tick-{digest}.so")
        if os.path.exists(so_path):
            return so_path
        cc = shutil.which("cc") or shutil.which("gcc") or \
            shutil.which("clang")
        if cc is None:
            return None
        try:
            os.makedirs(cand_dir, exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}"
            # -ffp-contract=off: the double-precision congestion math must
            # round exactly like numpy's (no FMA), or truncated cycle
            # budgets can differ by one and break engine equivalence.
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-ffp-contract=off",
                 src_path, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
            return so_path
        except (OSError, subprocess.SubprocessError):
            continue
    return None


def load_kernel():
    """Return the bound ``emu_run_ticks`` function, or None if unavailable.

    The result is cached for the process (including a negative result, so
    a missing compiler costs one probe, not one per simulation).
    """
    global _kernel, _load_attempted
    if _load_attempted:
        return _kernel
    _load_attempted = True
    if os.environ.get("REPRO_EMU_DISABLE_CEXT"):
        return None
    try:
        so_path = _compile(_SRC)
        if so_path is None:
            return None
        lib = ctypes.CDLL(so_path)
        fn = lib.emu_run_ticks
        fn.restype = _i64
        fn.argtypes = [
            # config
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _i64, _f64, _i64, _i64,
            # traces
            _arr(np.int64), _arr(np.int64), _arr(np.int64),
            # per-thread state
            _arr(np.int64), _arr(np.int8), _arr(np.int64), _arr(np.int64),
            _arr(np.int64), _arr(np.int64),
            # per-nodelet state
            _arr(np.int64), _arr(np.int64), _arr(np.int64),
            # scratch
            _arr(np.int64), _arr(np.int64), _arr(np.int64), _arr(np.int64),
            _arr(np.int64), _arr(np.int64), _arr(np.int64), _arr(np.float64),
            # residency buffer
            _arr(np.int32), _i64, _arr(np.int64),
            # loop registers
            _arr(np.int64), _arr(np.int64), _arr(np.int64), _arr(np.int64),
        ]
        _kernel = fn
    except OSError:
        _kernel = None
    return _kernel
