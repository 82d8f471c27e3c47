"""Persistent program artifacts: versioned on-disk bundles of lowered programs.

The paper's optimizations (reordering, distribution, kernel choice) only pay
off once their cost is amortized over enough SpMVs; a process restart that
re-probes the simulator and re-lowers every stage resets that clock to zero.
This module makes a lowered :class:`~repro_torch.core.program.SpmvProgram` durable:

* :func:`save_program` writes a *bundle* directory —

  - ``arrays.npz``: every numpy payload (the reordered matrix, partition
    starts, traffic vectors, the permutation, and each shard stage's
    ell/seg/split/tile slabs),
  - ``plan_choice.json``: the autotuner's full ranked
    :class:`~repro_torch.core.plan.PlanChoice` (optional; same JSON the plan
    layer has always round-tripped),
  - ``manifest.json``: schema version, the structure digest of the
    *source* (caller-order) matrix, the plan, and per-stage scalar
    metadata.  The manifest is written **last** via temp-file +
    ``os.replace``, and removed **first** on rewrite — a bundle without a
    valid manifest is simply not a bundle, so a crash mid-write can never
    yield a loadable-but-wrong artifact, and a serving-layer swap
    invalidates disk atomically before rewriting it.

* :func:`load_program` validates schema version and digest (raising
  :class:`ArtifactMismatch` so callers fall back to a fresh ``lower()``)
  and reconstructs the exact ``SpmvProgram``: every array round-trips
  bitwise through ``.npz``, and the executor outputs are bitwise equal to
  the freshly lowered program's.

* :func:`structure_digest` hashes shape, nnz, ``row_ptr``, ``col_index``
  *and* ``values``: a re-ingested matrix with identical structure but
  updated values must miss, otherwise a warm start would serve stale
  numerics bitwise-confidently.

The port's host copy of ``repro.core.artifacts`` (numpy only): the same
arithmetic, so its results equal the reference's bitwise.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

from .layout import make_layout
from .migration import TrafficReport
from .partition import Partition
from .plan import PlanChoice
from .program import ShardStage, SpmvProgram
from .sparse_matrix import CSRMatrix, EllMatrix, SegMatrix, SplitMatrix, \
    TileMatrix
from .spmv import SpmvPlan

__all__ = ["SCHEMA_VERSION", "ArtifactError", "ArtifactMissing",
           "ArtifactMismatch", "structure_digest", "save_program",
           "load_program", "invalidate_bundle"]

#: Bump when the bundle layout changes incompatibly.  Loaders reject any
#: other version (:class:`ArtifactMismatch`) so a fleet that skews across
#: releases falls back to a fresh ``lower()`` instead of misreading bytes.
SCHEMA_VERSION = 1

_FORMAT = "spmv-program-bundle"
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_CHOICE = "plan_choice.json"


class ArtifactError(Exception):
    """Base: this bundle cannot be used; fall back to a fresh lower()."""


class ArtifactMissing(ArtifactError):
    """No bundle (or no valid manifest — e.g. an interrupted write)."""


class ArtifactMismatch(ArtifactError):
    """Bundle exists but its schema version or structure digest disagrees."""


def structure_digest(csr: CSRMatrix) -> str:
    """Content hash of a CSR matrix in the caller's index order.

    Covers shape/nnz/``row_ptr``/``col_index``/``values`` — the full
    identity an artifact's bitwise-equality guarantee rests on.
    """
    h = hashlib.sha256(b"spmv-structure-v1")
    h.update(np.asarray([csr.nrows, csr.ncols, csr.nnz],
                        dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.row_ptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.col_index, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(csr.values, dtype=np.float64).tobytes())
    return h.hexdigest()


def _write_atomic(path: str, text: str) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _plan_to_dict(plan: SpmvPlan) -> dict:
    d = dataclasses.asdict(plan)
    for k in ("shard_kernels", "split_counts", "shard_exchanges"):
        if d[k] is not None:
            d[k] = list(d[k])
    return d


# Stage payload array fields, keyed ``s{p}_{field}`` in arrays.npz.  The
# scalar fields (nnz / chunk / num_splits) and the payload shape live in
# the manifest's per-stage entry.
_ELL_ARRAYS = ("data", "cols", "overflow_rows", "overflow_cols",
               "overflow_vals")
_SEG_ARRAYS = ("vals", "cols", "rows", "piece_chunk", "piece_lo",
               "piece_hi", "piece_row")
_SPLIT_ARRAYS = ("vals", "cols", "rows", "piece_split", "piece_chunk",
                 "piece_lo", "piece_hi", "piece_row")
_TILE_ARRAYS = ("tile_ptr", "tile_rows", "tile_cols", "data", "mask")


def _stage_entry(st: ShardStage, arrays: dict, p: int) -> dict:
    entry = {"kernel": st.kernel, "rows": int(st.rows),
             "row_offset": int(st.row_offset), "nnz": int(st.nnz)}
    if st.kernel in ("ell", "hyb"):
        entry["payload"] = {"shape": list(st.ell.shape),
                            "nnz": int(st.ell.nnz)}
        for f in _ELL_ARRAYS:
            arrays[f"s{p}_{f}"] = getattr(st.ell, f)
    elif st.kernel == "seg":
        entry["payload"] = {"shape": list(st.seg.shape),
                            "chunk": int(st.seg.chunk),
                            "nnz": int(st.seg.nnz)}
        for f in _SEG_ARRAYS:
            arrays[f"s{p}_{f}"] = getattr(st.seg, f)
    elif st.kernel == "split":
        entry["payload"] = {"shape": list(st.split.shape),
                            "chunk": int(st.split.chunk),
                            "num_splits": int(st.split.num_splits),
                            "nnz": int(st.split.nnz)}
        for f in _SPLIT_ARRAYS:
            arrays[f"s{p}_{f}"] = getattr(st.split, f)
    elif st.kernel == "tile":
        entry["payload"] = {"shape": list(st.tile.shape),
                            "bm": int(st.tile.bm), "bn": int(st.tile.bn),
                            "nnz": int(st.tile.nnz)}
        for f in _TILE_ARRAYS:
            arrays[f"s{p}_{f}"] = getattr(st.tile, f)
    else:  # pragma: no cover - lower() already validated the kernel
        raise ValueError(f"unknown stage kernel {st.kernel!r}")
    return entry


def _stage_from_entry(entry: dict, arrays, p: int) -> ShardStage:
    kernel = entry["kernel"]
    pay = entry["payload"]
    shape = tuple(pay["shape"])
    ell = seg = split = tile = None
    get = lambda f: arrays[f"s{p}_{f}"]  # noqa: E731
    if kernel in ("ell", "hyb"):
        ell = EllMatrix(shape=shape, data=get("data"), cols=get("cols"),
                        overflow_rows=get("overflow_rows"),
                        overflow_cols=get("overflow_cols"),
                        overflow_vals=get("overflow_vals"),
                        nnz=int(pay["nnz"]))
    elif kernel == "seg":
        seg = SegMatrix(shape=shape, chunk=int(pay["chunk"]),
                        vals=get("vals"), cols=get("cols"), rows=get("rows"),
                        piece_chunk=get("piece_chunk"),
                        piece_lo=get("piece_lo"), piece_hi=get("piece_hi"),
                        piece_row=get("piece_row"), nnz=int(pay["nnz"]))
    elif kernel == "split":
        split = SplitMatrix(shape=shape, chunk=int(pay["chunk"]),
                            num_splits=int(pay["num_splits"]),
                            vals=get("vals"), cols=get("cols"),
                            rows=get("rows"),
                            piece_split=get("piece_split"),
                            piece_chunk=get("piece_chunk"),
                            piece_lo=get("piece_lo"),
                            piece_hi=get("piece_hi"),
                            piece_row=get("piece_row"), nnz=int(pay["nnz"]))
    elif kernel == "tile":
        tile = TileMatrix(shape=shape, bm=int(pay["bm"]), bn=int(pay["bn"]),
                          tile_ptr=get("tile_ptr"),
                          tile_rows=get("tile_rows"),
                          tile_cols=get("tile_cols"), data=get("data"),
                          mask=get("mask"), nnz=int(pay["nnz"]))
    else:
        raise ArtifactMismatch(f"unknown stage kernel {kernel!r} in bundle")
    return ShardStage(shard=p, kernel=kernel, rows=int(entry["rows"]),
                      row_offset=int(entry["row_offset"]),
                      nnz=int(entry["nnz"]), ell=ell, seg=seg, split=split,
                      tile=tile)


def invalidate_bundle(bundle_dir: str) -> None:
    """Atomically mark a bundle unusable (manifest removal is the commit
    point for both invalidation and rewrite)."""
    try:
        os.remove(os.path.join(bundle_dir, _MANIFEST))
    except FileNotFoundError:
        pass


def save_program(program: SpmvProgram, bundle_dir: str, *,
                 source: CSRMatrix | None = None,
                 choice: PlanChoice | None = None) -> str:
    """Write ``program`` as a versioned bundle directory; returns the path.

    ``source`` is the matrix in the *caller's* index order (what the
    serving layer was handed at ingest) — the digest future loads are
    validated against.  It may be omitted only for unreordered programs,
    where ``program.matrix`` is already in caller order.

    Write protocol: remove the old manifest first, arrays and choice next,
    manifest last (each file via temp + ``os.replace``).  Readers treat a
    manifest-less directory as :class:`ArtifactMissing`, so every
    intermediate state of this sequence — including a crash — reads as
    "no artifact", never as a stale or torn one.
    """
    if source is None:
        if program.perm is not None:
            raise ValueError("reordered programs need source= (the matrix "
                             "in caller index order) to digest against")
        source = program.matrix
    os.makedirs(bundle_dir, exist_ok=True)
    invalidate_bundle(bundle_dir)

    arrays: dict = {
        "mat_values": program.matrix.values,
        "mat_col_index": program.matrix.col_index,
        "mat_row_ptr": program.matrix.row_ptr,
        "part_starts": program.partition.starts,
        "traffic_mem_instr": program.traffic.mem_instr_per_nodelet,
        "traffic_inbound_x": program.traffic.inbound_x_loads,
        "traffic_nnz": program.traffic.nnz_per_nodelet,
        "shard_traffic": program.shard_traffic,
    }
    if program.perm is not None:
        arrays["perm"] = program.perm
    stages = [_stage_entry(st, arrays, p)
              for p, st in enumerate(program.stages)]

    npz_path = os.path.join(bundle_dir, _ARRAYS)
    npz_tmp = f"{npz_path}.tmp{os.getpid()}.npz"
    np.savez(npz_tmp, **arrays)
    os.replace(npz_tmp, npz_path)

    choice_path = os.path.join(bundle_dir, _CHOICE)
    if choice is not None:
        _write_atomic(choice_path, choice.to_json(indent=1))
    elif os.path.exists(choice_path):
        os.remove(choice_path)

    manifest = {
        "format": _FORMAT,
        "schema_version": SCHEMA_VERSION,
        "digest": structure_digest(source),
        "plan": _plan_to_dict(program.plan),
        "shape": [program.matrix.nrows, program.matrix.ncols],
        "partition_strategy": program.partition.strategy,
        "traffic": {
            "migrations": int(program.traffic.migrations),
            "remote_x_loads": int(program.traffic.remote_x_loads),
            "remote_b_updates": int(program.traffic.remote_b_updates),
        },
        "stages": stages,
        "has_choice": choice is not None,
    }
    _write_atomic(os.path.join(bundle_dir, _MANIFEST),
                  json.dumps(manifest, indent=1))
    return bundle_dir


def load_program(bundle_dir: str, *, expect: CSRMatrix | None = None
                 ) -> tuple[SpmvProgram, PlanChoice | None]:
    """Load a bundle back into an exact :class:`SpmvProgram`.

    ``expect`` (the matrix being ingested, caller index order) arms the
    digest check; schema-version skew or a digest miss raises
    :class:`ArtifactMismatch`, an absent/torn bundle raises
    :class:`ArtifactMissing` — both signals to fall back to ``lower()``.
    """
    manifest_path = os.path.join(bundle_dir, _MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError) as e:
        raise ArtifactMissing(f"no readable manifest in {bundle_dir}") from e
    if manifest.get("format") != _FORMAT:
        raise ArtifactMismatch(f"not a {_FORMAT}: {bundle_dir}")
    version = manifest.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ArtifactMismatch(
            f"bundle schema {version!r} != supported {SCHEMA_VERSION}")
    if expect is not None and manifest["digest"] != structure_digest(expect):
        raise ArtifactMismatch("structure digest mismatch: bundle was built "
                               "from a different matrix")

    try:
        arrays = np.load(os.path.join(bundle_dir, _ARRAYS))
    except (FileNotFoundError, ValueError, OSError) as e:
        raise ArtifactMissing(f"unreadable {_ARRAYS} in {bundle_dir}") from e

    plan = SpmvPlan(**manifest["plan"])
    M, N = (int(v) for v in manifest["shape"])
    matrix = CSRMatrix(shape=(M, N), values=arrays["mat_values"],
                       col_index=arrays["mat_col_index"],
                       row_ptr=arrays["mat_row_ptr"])
    part = Partition(strategy=manifest["partition_strategy"],
                     num_shards=plan.num_shards,
                     starts=arrays["part_starts"])
    traffic = TrafficReport(
        migrations=int(manifest["traffic"]["migrations"]),
        remote_x_loads=int(manifest["traffic"]["remote_x_loads"]),
        remote_b_updates=int(manifest["traffic"]["remote_b_updates"]),
        mem_instr_per_nodelet=arrays["traffic_mem_instr"],
        inbound_x_loads=arrays["traffic_inbound_x"],
        nnz_per_nodelet=arrays["traffic_nnz"])
    stages = tuple(_stage_from_entry(entry, arrays, p)
                   for p, entry in enumerate(manifest["stages"]))
    perm = arrays["perm"] if "perm" in arrays.files else None

    program = SpmvProgram(
        plan=plan, matrix=matrix, partition=part,
        x_layout=make_layout(plan.layout, N, plan.num_shards),
        b_layout=make_layout(plan.layout, M, plan.num_shards),
        rows_per_shard=part.rows_per_shard().astype(np.int64),
        row_offset=part.starts[:-1].astype(np.int64),
        traffic=traffic, shard_traffic=arrays["shard_traffic"],
        stages=stages, perm=perm)

    choice = None
    choice_path = os.path.join(bundle_dir, _CHOICE)
    if manifest.get("has_choice") and os.path.exists(choice_path):
        with open(choice_path) as f:
            choice = PlanChoice.from_json(f.read())
    return program, choice
