"""The system under test: the ``repro_torch`` package beside ``bench/``.

Everything the benchmark asks of the program goes through here: its
CUDA kernel library, the lowering and the graph-replayed executor, and
the program's own layout of x and y.  The
program gets read-only views of the benchmark's CSR, so it cannot change
what the reference reads.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["REPO", "import_program", "load_kernels", "sync", "Executor"]

REPO = Path(__file__).resolve().parents[2]


def import_program():
    """The program's modules (``repro_torch`` from ``<repo>/src``)."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core.program as program
    import repro_torch.core.sparse_matrix as sparse_matrix
    import repro_torch.core.spmv as spmv
    return program, sparse_matrix, spmv


def _read_only(a: np.ndarray) -> np.ndarray:
    v = a.view()
    v.flags.writeable = False
    return v


def _program_csr(csr):
    _, sparse_matrix, _ = import_program()
    return sparse_matrix.CSRMatrix(
        shape=tuple(csr.shape), values=_read_only(csr.values),
        col_index=_read_only(csr.col_index), row_ptr=_read_only(csr.row_ptr))


def load_kernels(device) -> dict:
    """Build the program's CUDA kernel library if this checkout has not
    built it yet, and load it.  Returns ``kernel_build_s`` (the build's
    seconds by the program's own count, 0 where it was found built) and
    ``kernel_load_s`` (the wall time of both); nothing on the CPU."""
    if device.type != "cuda":
        return {}
    import_program()
    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.lib()
    return {"kernel_build_s": float(_lib.build_info.get("seconds", 0.0)),
            "kernel_load_s": time.perf_counter() - t0}


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """``lower`` + ``make_program_spmv_fn(graphs=True)`` (graphs on CUDA
    only: the CPU has none); ``lower_s`` covers both and the upload."""

    def __init__(self, csr, plan: dict, device: torch.device):
        program_mod, _, spmv = import_program()
        self.device = device
        t0 = time.perf_counter()
        self.program = program_mod.lower(_program_csr(csr),
                                         spmv.SpmvPlan(**plan))
        self.run = program_mod.make_program_spmv_fn(
            self.program, device=device, graphs=device.type == "cuda")
        sync(device)
        self.lower_s = time.perf_counter() - t0
        self._gather_b = program_mod.gather_b

    def x_shards(self, x: np.ndarray) -> torch.Tensor:
        """x (N[, B]) in the caller's order -> (S, per[, B]) float32 on
        the device, in the program's layout order."""
        p = self.program
        if p.perm is not None:
            xp = np.empty_like(x)
            xp[p.perm] = x
            x = xp
        return torch.from_numpy(p.x_to_device(x)).to(self.device)

    def y_caller(self, y_shards) -> np.ndarray:
        """An executor output -> y (M[, B]) in the caller's order."""
        return self._gather_b(self.program, y_shards)

    def exchange_bytes(self, x_shards) -> int:
        """Bytes of the remote pass's buffer that the exchange builds for
        ``x_shards``."""
        _, xg = self.run.buffers(x_shards)
        sync(self.device)
        return int(xg.numel() * xg.element_size())

