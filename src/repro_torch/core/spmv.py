"""The SpMV plan: layout x distribution x reordering x exchange x kernel.

Host copy of ``repro.core.spmv.SpmvPlan`` and its spellings, of the
warn-once helper of the deprecated shims, and of the pre-IR aliases
``build_distributed`` (``lower``), ``local_spmv`` (the numpy executor),
``lower_with_exchange`` and ``DistributedSpmv`` (``SpmvProgram``).
``SpmvPlan.auto`` runs the autotuner of :mod:`repro_torch.core.plan`.
The deprecated ``make_*_fn`` shims and ``build_halo`` are not carried
over: they need the legacy stacked-slab views.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import numpy as np

from .sparse_matrix import CSRMatrix

__all__ = ["PLAN_KERNELS", "PLAN_EXCHANGES", "SpmvPlan", "DistributedSpmv",
           "build_distributed", "local_spmv", "lower_with_exchange"]

#: Kernel spellings a plan accepts, in the reference's order; a shard's
#: kernel id is its index here.
PLAN_KERNELS = ("ell", "seg", "hyb", "split", "tile")

#: Exchange policies a plan accepts (uniform or per-shard).
PLAN_EXCHANGES = ("halo", "allgather")


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """The paper's optimization grid as one config object.

    ``shard_kernels`` / ``split_counts`` / ``shard_exchanges`` override the
    kernel, the split count NS and the exchange per shard; ``None`` means
    the uniform ``kernel`` / the ``split_meta`` policy / the uniform
    ``exchange``.
    """

    layout: Literal["block", "cyclic"] = "block"
    distribution: Literal["row", "nonzero", "nnz"] = "nonzero"
    reordering: Literal["none", "random", "bfs", "metis", "degree"] = "none"
    exchange: Literal["allgather", "halo"] = "halo"
    kernel: Literal["ell", "seg", "hyb", "split", "tile"] = "ell"
    num_shards: int = 8
    seed: int = 0
    shard_kernels: tuple | None = None
    split_counts: tuple | None = None
    shard_exchanges: tuple | None = None

    def __post_init__(self):
        if self.shard_kernels is not None:
            sk = tuple(self.shard_kernels)
            bad = [k for k in sk if k not in PLAN_KERNELS]
            if bad:
                raise ValueError(f"unknown shard kernel(s) {bad!r}; expected "
                                 f"entries from {PLAN_KERNELS}")
            object.__setattr__(self, "shard_kernels", sk)
        if self.split_counts is not None:
            sc = tuple(int(c) for c in self.split_counts)
            if any(c < 1 for c in sc):
                raise ValueError(f"split_counts must be >= 1, got {sc!r}")
            object.__setattr__(self, "split_counts", sc)
        if self.shard_exchanges is not None:
            se = tuple(self.shard_exchanges)
            bad = [e for e in se if e not in PLAN_EXCHANGES]
            if bad:
                raise ValueError(f"unknown shard exchange(s) {bad!r}; "
                                 f"expected entries from {PLAN_EXCHANGES}")
            object.__setattr__(self, "shard_exchanges", se)

    def _per_shard(self, name: str, value, uniform):
        if value is None:
            return (uniform,) * self.num_shards
        if len(value) != self.num_shards:
            raise ValueError(f"{name} has {len(value)} entries but "
                             f"num_shards={self.num_shards}")
        return value

    def resolved_shard_kernels(self) -> tuple:
        """The per-shard kernel tuple this plan lowers to (length S)."""
        return self._per_shard("shard_kernels", self.shard_kernels,
                               self.kernel)

    def resolved_shard_exchanges(self) -> tuple:
        """The per-shard exchange tuple this plan executes with (length S)."""
        return self._per_shard("shard_exchanges", self.shard_exchanges,
                               self.exchange)

    def resolved_split_counts(self) -> tuple:
        """Per-shard split-count requests (length S; 0 = policy decides)."""
        return self._per_shard("split_counts", self.split_counts, 0)

    @classmethod
    def auto(cls, csr: CSRMatrix, *, num_shards: int = 8, seed: int = 0,
             probe: int | str | None = None, **grid) -> "SpmvPlan":
        """Pick a plan for ``csr`` with the cost-model autotuner: a thin
        wrapper over :func:`repro_torch.core.plan.autotune` (which see for
        the grid and ``probe``) that returns only the winning plan."""
        from .plan import autotune
        return autotune(csr, num_shards=num_shards, seed=seed, probe=probe,
                        **grid).plan


#: Shims that already warned this process: each deprecated shim emits its
#: DeprecationWarning exactly once, so a tight legacy loop is not spammed.
_DEPRECATION_WARNED: set = set()


def _warn_deprecated(name: str, replacement: str) -> None:
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use {replacement} instead",
        DeprecationWarning, stacklevel=3)


def build_distributed(csr: CSRMatrix, plan: SpmvPlan):
    """Deprecated alias of :func:`repro_torch.core.program.lower`."""
    from .program import lower
    return lower(csr, plan)


def local_spmv(dist, x: np.ndarray) -> np.ndarray:
    """Single-host execution of a lowered program: y = A @ x in the
    caller's order, float64; alias of ``execute(dist, x,
    backend="numpy")``.  ``x`` is (N,) or (N, B)."""
    from .program import execute
    return execute(dist, x, backend="numpy")


def lower_with_exchange(program, new_plan: SpmvPlan):
    """Clone a program under a different exchange (same base otherwise):
    the exchange only changes the executor's prologue, so every stage and
    accounting object is shared with the source program."""
    return dataclasses.replace(program, plan=new_plan)


def __getattr__(name):
    if name == "DistributedSpmv":       # deprecated alias of the program IR
        from .program import SpmvProgram
        return SpmvProgram
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
