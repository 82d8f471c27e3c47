"""The SpMV plan: layout x distribution x reordering x exchange x kernel.

Host copy of ``repro.core.spmv.SpmvPlan`` and its spellings, and of the
warn-once helper of the deprecated shims.  The plan is given explicitly
in this port: the autotuner (``SpmvPlan.auto``) is not ported yet and
raises.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

__all__ = ["PLAN_KERNELS", "PLAN_EXCHANGES", "SpmvPlan"]

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
    def auto(cls, csr, **kwargs) -> "SpmvPlan":
        raise NotImplementedError(
            "SpmvPlan.auto needs the autotuner (plan.autotune, the cost "
            "oracle and the Emu probe), which a later port slice brings; "
            "pass an explicit SpmvPlan")


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
