"""The SpMV plan: layout x distribution x reordering x exchange x kernel.

Host copy of ``repro.core.spmv``: ``SpmvPlan`` and its spellings, the
halo-exchange accounting (:func:`build_halo`, :class:`HaloProgram`, read
from the program's legacy stacked-slab views), and the pre-IR aliases
``build_distributed`` (``lower``), ``local_spmv`` (the numpy executor),
``lower_with_exchange`` and ``DistributedSpmv`` (``SpmvProgram``).
``SpmvPlan.auto`` runs the autotuner of :mod:`repro_torch.core.plan`.

The deprecated shims ``make_spmv_fn``, ``make_seg_spmv_fn`` and
``make_halo_spmv_fn`` keep their old call signatures over
:func:`repro_torch.core.program.make_program_spmv_fn`: each takes the
reference's positional ``mesh`` and ``axis`` (a
:mod:`repro_torch.launch.mesh` mesh; over a distributed one each rank's
function returns its block of shards) or, without a mesh, ``device=``
(CUDA unless ``device="cpu"``), warns once, and re-binds the exchange as
the reference does (all-gather for the first two, halo for the
third).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Literal

import numpy as np

from .sparse_matrix import CSRMatrix

__all__ = ["PLAN_KERNELS", "PLAN_EXCHANGES", "SpmvPlan", "DistributedSpmv",
           "build_distributed", "local_spmv", "lower_with_exchange",
           "make_spmv_fn", "make_seg_spmv_fn", "HaloProgram", "build_halo",
           "make_halo_spmv_fn"]

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

    def retarget(self, num_shards: int) -> "SpmvPlan":
        """Re-target to a different shard count.  A per-shard kernel, split
        or exchange tuple tuned for another shard count is dropped (the
        plan falls back to its uniform ``kernel`` / the split policy / its
        uniform ``exchange``) instead of producing an unlowerable plan."""
        sk = self.shard_kernels
        if sk is not None and len(sk) != num_shards:
            sk = None
        sc = self.split_counts
        if sc is not None and len(sc) != num_shards:
            sc = None
        se = self.shard_exchanges
        if se is not None and len(se) != num_shards:
            se = None
        return dataclasses.replace(self, num_shards=num_shards,
                                   shard_kernels=sk, split_counts=sc,
                                   shard_exchanges=se)

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


def _rebound(dist, exchange: str):
    """``dist`` under the uniform ``exchange`` (stages shared), as the
    historical factories always built it whatever the plan said."""
    if dist.plan.exchange == exchange and not dist.plan.shard_exchanges:
        return dist
    return lower_with_exchange(dist, dataclasses.replace(
        dist.plan, exchange=exchange, shard_exchanges=None))


def make_spmv_fn(dist, mesh=None, axis: str = "model", *, device=None):
    """Deprecated shim over
    :func:`repro_torch.core.program.make_program_spmv_fn` with the old
    ``f(data, cols, x_shards) -> y_shards`` signature; the slab arguments
    are accepted and ignored (the program carries its operands).  The
    exchange is always all-gather: a halo plan is re-bound first."""
    _warn_deprecated("make_spmv_fn",
                     "repro_torch.core.program.make_program_spmv_fn")
    from .program import make_program_spmv_fn
    inner = make_program_spmv_fn(_rebound(dist, "allgather"), mesh, axis,
                                 device=device)

    def fn(data, cols, x_shards):
        del data, cols
        return inner(x_shards)
    return fn


def make_seg_spmv_fn(dist, mesh=None, axis: str = "model", *,
                     device=None):
    """Deprecated shim over
    :func:`repro_torch.core.program.make_program_spmv_fn` for uniform-seg
    programs (old ``f(vals, cols, rows, pieces, x_shards)`` signature,
    all-gather, rows cut to the largest shard's)."""
    _warn_deprecated("make_seg_spmv_fn",
                     "repro_torch.core.program.make_program_spmv_fn")
    if any(st.kernel != "seg" for st in dist.stages):
        raise ValueError("build_distributed was not run with plan.kernel='seg'")
    from .program import make_program_spmv_fn
    inner = make_program_spmv_fn(_rebound(dist, "allgather"), mesh, axis,
                                 device=device)
    rows_pad = int(dist.rows_per_shard.max())

    def fn(vals, cols, rows, pieces, x_shards):
        del vals, cols, rows, pieces
        return inner(x_shards)[:, :rows_pad]
    return fn


@dataclasses.dataclass
class HaloProgram:
    """Host-precomputed halo exchange for one lowered program.

    Shard q sends to shard p exactly the x entries p's rows read from q
    (``send_idx[q, p]``, padded to the max halo H); the ELL column ids are
    remapped into [local_x ++ recv_buffer].
    """

    send_idx: np.ndarray      # (S, S, H) local indices on the sender
    cols_remap: np.ndarray    # (S, rows_pad, W) into the augmented buffer
    halo: int                 # H
    comm_elems_per_shard: int  # S * H (vs padded_length for all-gather)


def build_halo(dist) -> HaloProgram:
    """The halo exchange of ``dist``'s legacy stacked ELL view: the
    exchange-bytes accounting surface (S*H elements a shard against the
    padded length of an all-gather)."""
    S = dist.plan.num_shards
    lay = dist.x_layout
    per = lay.padded_length() // S
    # Padded ELL slots (and stored zeros) carry value 0 and point at col 0;
    # they add nothing to y, so they must not widen the halo.
    needed = [[None] * S for _ in range(S)]
    for p in range(S):
        cols_p = dist.cols[p].reshape(-1)
        act_p = dist.data[p].reshape(-1) != 0
        own_p = lay.owner_of(cols_p)
        for q in range(S):
            ids = np.unique(cols_p[act_p & (own_p == q)]) if q != p \
                else np.zeros(0, np.int64)
            needed[p][q] = ids
    H = max((ids.size for row in needed for ids in row), default=1)
    H = max(H, 1)
    send_idx = np.zeros((S, S, H), dtype=np.int32)
    # augmented-buffer position of each global id, per receiving shard p
    recv_pos = [dict() for _ in range(S)]
    for p in range(S):
        for q in range(S):
            ids = needed[p][q]
            send_idx[q, p, : ids.size] = lay.local_index(ids)
            base = per + q * H
            for slot, gid in enumerate(ids):
                recv_pos[p][int(gid)] = base + slot
    cols_remap = np.zeros_like(dist.cols)
    for p in range(S):
        cols_p = dist.cols[p]
        own_p = lay.owner_of(cols_p)
        local = lay.local_index(cols_p)
        remap = np.where(own_p == p, local, 0)
        # Zero-value slots keep remap 0: x_local[0] times value 0 is 0.
        rem_mask = (own_p != p) & (dist.data[p] != 0)
        if rem_mask.any():
            flat = cols_p[rem_mask]
            remap[rem_mask] = np.array([recv_pos[p][int(g)] for g in flat],
                                       dtype=np.int32)
        cols_remap[p] = remap
    return HaloProgram(send_idx=send_idx, cols_remap=cols_remap, halo=H,
                       comm_elems_per_shard=S * H)


def make_halo_spmv_fn(dist, halo: HaloProgram, mesh=None,
                      axis: str = "model", *, device=None):
    """Deprecated shim over
    :func:`repro_torch.core.program.make_program_spmv_fn` (old
    ``f(data, cols_remap, send_idx, x_shards)`` signature).  The plan's
    own halo prologue runs; a non-halo plan is re-bound to the uniform
    halo exchange first, as the historical factory always built it."""
    _warn_deprecated("make_halo_spmv_fn",
                     "repro_torch.core.program.make_program_spmv_fn")
    from .program import make_program_spmv_fn
    inner = make_program_spmv_fn(_rebound(dist, "halo"), mesh, axis,
                                 device=device)

    def fn(data, cols_remap, send_idx, x_shards):
        del data, cols_remap, send_idx
        return inner(x_shards)
    return fn


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
