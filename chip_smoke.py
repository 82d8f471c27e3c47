#!/usr/bin/env python3
"""Drive the port's sparse device path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full run, one card

Builds the CUDA kernels from ``src/repro_torch/csrc``, then runs a
``planner`` phase on the host, three phases through the executor's entry
points (``lower``, ``make_program_spmv_fn``, ``gather_b``) and a
``kernel_api`` phase through the per-format kernel API
(``repro_torch.kernels``):

* ``planner``: ``autotune(make_matrix("cop20k_A"), num_shards=8)`` at
  the full Table-I size (120,000 rows) with the default probe must pick
  ``bfs/block/nonzero/halo/seg``; ``execute(prog, backend="emu")`` on
  that program with the ``cext`` and ``numpy`` engines must give equal
  ``EmuResult``s; ``relower`` to a plan with shards 0 and 1 on ``ell``
  must keep stages 2-7 as the same objects and answer on the card
  bitwise as ``lower`` of that plan does; a program saved with
  ``save_program`` and read back with ``load_program`` must answer on
  the card bitwise as the original.  Both pass the |A|·|x|-scaled
  check below.  Prints one ``{"planner": ...}`` line of host seconds;
* ``cop20k_A``: the same matrix under the autotuner's choice (so the
  main path runs host CSR -> ``autotune`` -> ``lower`` -> the kernels)
  and under ``cyclic/allgather/ell``;
* ``blocked_band``: 131,072 rows, a heterogeneous tile/ell/hyb/seg/split
  program with mixed exchanges;
* ``powerlaw_tail``: 131,072 rows under ``split`` (NS from
  ``split_meta``);
* ``kernel_api``: ``split_spmv`` on ``split_from_csr`` of the
  powerlaw_tail matrix with NS = 8 and 64 (``api/split8``,
  ``api/split64``) and with NS = 64 at chunk 4096
  (``api/split64_4096``), ``tile_spmv`` on ``tile_from_csr`` of the
  blocked_band matrix with (8, 128) tiles (``api/tile``) and (16, 64)
  tiles (``api/tile16x64``, the general walk), ``seg_spmv`` on cop20k_A
  at chunk 512 and 2048 (``api/seg``, ``api/seg2048``), ``hyb_spmv`` and
  ``ell_spmv`` on the full cop20k_A formats, and the
  deprecated ``bell_spmv`` / ``bell_spmm`` on ``csr_to_bcsr`` of a
  smaller ``blocked_band(16384, 32·16384)`` with (8, 128) blocks: the
  padded Block-ELL slab grows with the widest block row (59 blocks here,
  495 MB), so the shim runs at an eighth of the rows.

Each program or API call answers four single vectors and one (N, 8)
block with the launch counts zeroed just before and read just after,
then checks y against the float64 ``csr_matvec`` (|A|·|x|-scaled error
<= 2e-4), two runs bitwise (and pipeline on/off for the executor), and
each batched column against the per-vector call bitwise.  Every kernel
launch of one SpMV is then replayed against its plain PyTorch version
on the same inputs (rtol = atol = 1e-5 on |A|·|x|-scaled values; the
carry fix-up and the combine exactly) and timed with CUDA events beside
its memory bound, the plain version and a PyTorch library call; the
launches of the (N, 8) block are replayed, checked and timed the same
way (``kernels_b8``, ``ms_b8`` in the summary).  ``tile_contrib``'s
output starts as NaN, so an entry it does not write fails its check.
Any failed check raises.  Exits non-zero, printing no result, without
CUDA or without the port.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
E2E_TOL = 2e-4
KERNEL_TOL = 1e-5
REPLACES = {
    "ell_spmv": "src/repro/kernels/spmv_ell.py:45",
    "seg_psum": "src/repro/kernels/spmv_seg.py:42",
    "seg_fixup": "src/repro/kernels/ops.py:158",
    "split_combine": "src/repro/kernels/spmv_split.py:77",
    "tile_contrib": "src/repro/kernels/spmv_tile.py:91",
    "split_psum": "src/repro/kernels/spmv_split.py:43",
    "tile_walk_spmv": "src/repro/kernels/spmv_tile.py:51",
}
SOURCE = {
    "ell_spmv": "src/repro_torch/csrc/spmv_ell.cu",
    "seg_psum": "src/repro_torch/csrc/spmv_seg.cu",
    "seg_fixup": "src/repro_torch/csrc/spmv_seg.cu",
    "split_combine": "src/repro_torch/csrc/spmv_split.cu",
    "tile_contrib": "src/repro_torch/csrc/spmv_tile.cu",
    "split_psum": "src/repro_torch/csrc/spmv_split.cu",
    "tile_walk_spmv": "src/repro_torch/csrc/spmv_tile.cu",
}
#: The phase whose numbers stand for each kernel in the summary line.
HEADLINE = {"ell_spmv": "cop20k_A/ell", "seg_psum": "cop20k_A/seg",
            "seg_fixup": "cop20k_A/seg", "split_combine": "powerlaw_tail",
            "tile_contrib": "blocked_band", "split_psum": "api/split64",
            "tile_walk_spmv": "api/tile"}


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def cuda_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` replayed as a captured CUDA graph: the
    work on the card without the host's per-launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, iters)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def distinct(torch, positions, shared: bool) -> int:
    """Distinct positions among per-shard index tensors: within each shard,
    or across all of them when the shards read one shared buffer."""
    if not positions:
        return 0
    if shared:
        return int(torch.cat(positions).unique().numel())
    return sum(int(p.unique().numel()) for p in positions)


def replays(torch, run, xs):
    """Every kernel launch of one SpMV on ``xs``, as replayable records:
    the kernel call, its plain version on the same inputs, how to compare
    them, the plain version on |inputs| (the |A|·|x| scale), and the bytes
    and flops the launch must move and do on this run's operands.

    Bytes count what the launch reads and writes, once each: the stacked
    seg slabs of its shards in full (the kernels walk every slot), the ELL
    slots only up to each row's ``ell_len`` (8 bytes a real slot, plus the
    4-byte ``ell_len`` of every row; the earlier kernel walked, and this
    counted, the whole padded slab), the overflow entries, pieces and
    tiles only up to each shard's real count (past it the kernels read
    nothing; a piece is its whole 20-byte record, whose sectors the
    fix-up's reads of 3 or 4 of its ints cover), every gather (x, and the
    fix-up's psum) at 4 bytes per distinct position, and the output
    (every (row, split) entry of the fix-up's)."""
    xb, xg = run.buffers(xs)
    out = []
    for pre, x in (("loc_", xb), ("rem_", xg)):
        for fam, sids in run.families.items():
            out += family_replays(torch, run, pre, x, fam, sids)
    return out


def family_replays(torch, run, pre, x, fam, sids):
    from repro_torch.kernels import spmv_ell, spmv_seg, spmv_split, spmv_tile

    T, R = run.operands, run.rows_out
    S = T["kid"].numel()
    B = x.shape[1]
    n = sids.numel()
    frac = n / S
    shards = sids.long().tolist()
    ybytes = n * B * R * 4
    ax = torch.abs(x)
    recs = []

    def x_bytes(positions):
        return 4 * B * distinct(torch, positions, shared=x.shape[0] == 1)

    def real(ptr):
        """Each listed shard's real entry count, the last of its ranges."""
        return ptr[sids.long(), ptr.shape[1] - 1].tolist()

    def y_out():
        return torch.empty((S, B, R), device=x.device)

    def rec(name, kernel, plain, scale, byts, flops, *, exact=False,
            by_sid=True, plain_timed=None, library=None):
        recs.append(dict(name=name, family=fam, pass_=pre, kernel=kernel,
                         plain=plain, scale=scale, bytes=byts, ops=flops,
                         exact=exact, rows=sids.long() if by_sid else None,
                         plain_timed=plain_timed or plain, library=library))

    if fam in ("ell", "hyb"):
        a = [T[pre + k] for k in ("ell_data", "ell_cols", "ovf_rows",
                                  "ovf_cols", "ovf_vals", "ovf_ptr")]
        data, cols, _, ovf_cols, _, ovf_ptr = a
        ell_len = T[pre + "ell_len"]
        absa = [torch.abs(a[0])] + a[1:4] + [torch.abs(a[4]), a[5]]
        n_ovf = real(ovf_ptr)
        slots = torch.arange(data.shape[2], device=x.device)
        gathered = [torch.cat([cols[s][slots < ell_len[s][:, None]],
                               ovf_cols[s, :m]])
                    for s, m in zip(shards, n_ovf)]
        n_slots = int(ell_len[sids.long()].sum())
        rec("ell_spmv",
            lambda: spmv_ell.ell_spmv(*a, x, sids, ell_len=ell_len,
                                      out=y_out()),
            lambda: spmv_ell.ell_spmv_plain(*a, x, sids, y_out(),
                                            ell_len=ell_len),
            lambda: spmv_ell.ell_spmv_plain(*absa, ax, sids, y_out(),
                                            ell_len=ell_len),
            8 * n_slots + 4 * n * R + 8 * sum(n_ovf)
            + 4 * n * ovf_ptr.shape[1] + x_bytes(gathered) + ybytes + 4 * n,
            2 * B * (n_slots + sum(n_ovf)))
        return recs
    if fam == "tile":
        a = [T[pre + k] for k in ("tile_data", "tile_xcol", "tile_brow",
                                  "tile_ptr")]
        data, xcol, _, tile_ptr = a
        n_tiles = real(tile_ptr)
        tile_elems = data[0, 0].numel()
        gathered = [xcol[s, :m].reshape(-1) for s, m in zip(shards, n_tiles)]
        # NaN until the first call, the checked one, which must write every
        # entry; the timed calls rewrite the same buffer and launch nothing
        # else
        poisoned = torch.full((S, B, R), float("nan"), device=x.device)
        rec("tile_contrib",
            lambda: spmv_tile.tile_contrib(
                *a, x, sids, rb_used=run.rb_used[pre], out=poisoned),
            lambda: spmv_tile.tile_contrib_plain(*a[:3], x, sids, y_out()),
            lambda: spmv_tile.tile_contrib_plain(torch.abs(a[0]), *a[1:3],
                                                 ax, sids, y_out()),
            4 * sum(n_tiles) * (tile_elems + xcol.shape[2])
            + 4 * n * tile_ptr.shape[1] + x_bytes(gathered) + ybytes + 4 * n,
            2 * B * sum(n_tiles) * tile_elems)
        return recs
    # seg and split: stage 1 is seg_psum, then the carry fix-up
    v, c, pcs, ptr = (T[pre + k] for k in ("seg_vals", "seg_cols",
                                           "seg_pieces", "piece_ptr"))
    C, L = v.shape[1], v.shape[2]

    def psum_out():
        return torch.empty((n, B, C, L), device=x.device)

    rec("seg_psum",
        lambda: spmv_seg.seg_psum(v, c, x, sids),
        lambda: spmv_seg.seg_psum_plain(v, c, x, sids, psum_out()),
        lambda: spmv_seg.seg_psum_plain(torch.abs(v), c, ax, sids,
                                        psum_out()),
        frac * nbytes(v, c) + x_bytes([c[s].reshape(-1) for s in shards])
        + n * B * C * L * 4 + 4 * n,
        2 * n * B * C * L, by_sid=False)
    psum = spmv_seg.seg_psum(v, c, x, sids)
    ns = 1 if fam == "seg" else run.num_splits[pre]
    ids = sids if fam == "seg" else torch.arange(n, dtype=torch.int32,
                                                 device=x.device)

    def fix_out(device=x.device):
        shape = (S, B, R) if fam == "seg" else (n, B, ns, R)
        return torch.empty(shape, device=device)

    n_pieces = real(ptr)
    read_at = []                       # psum[chunk, hi] and psum[chunk, lo-1]
    for s, m in zip(shards, n_pieces):
        chunk, lo, hi = pcs[s, :m, :3].long().unbind(1)
        live = lo <= hi
        read_at.append(torch.cat([(chunk * L + hi)[live],
                                  (chunk * L + lo - 1)[live & (lo > 0)]]))
    cpu = [t.cpu() for t in (psum, pcs, ptr, sids, ids)]
    rec("seg_fixup",
        lambda: spmv_seg.seg_fixup(psum, pcs, ptr, sids, ids, num_splits=ns,
                                   out=fix_out()),
        # CUDA's index_add_ has no fixed order: the exact check runs the
        # plain version on the CPU copies of the same inputs
        lambda: spmv_seg.seg_fixup_plain(*cpu, fix_out("cpu")),
        None, 4 * B * distinct(torch, read_at, shared=False)
        + 20 * sum(n_pieces) + 4 * n * ptr.shape[1] + 8 * n
        + n * B * ns * R * 4, 2 * B * sum(n_pieces), exact=True,
        by_sid=fam == "seg",
        plain_timed=lambda: spmv_seg.seg_fixup_plain(psum, pcs, ptr, sids,
                                                     ids, fix_out()))
    if fam == "split":
        part = spmv_seg.seg_fixup(psum, pcs, ptr, sids, ids, num_splits=ns,
                                  out=fix_out())
        rec("split_combine",
            lambda: spmv_split.split_combine(part, sids, out=y_out()),
            lambda: spmv_split.split_combine_plain(part, sids, y_out()),
            None, nbytes(part) + ybytes + 4 * n, n * B * ns * R, exact=True,
            library=lambda: part.sum(dim=2))
    return recs


def csr_tensor(torch, crow, cols, vals, shape, device):
    warnings.filterwarnings("ignore", message="Sparse")
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(crow, np.int64)),
        torch.from_numpy(cols.astype(np.int64)),
        torch.from_numpy(vals.astype(np.float32)), size=shape, device=device)


def family_csr(torch, prog, sids, device):
    """The rows of the shards ``sids`` as one torch CSR matrix (the
    library yardstick's operand)."""
    A, starts = prog.matrix, prog.partition.starts
    spans = [(int(starts[p]), int(starts[p + 1])) for p in sids.tolist()]
    counts = np.concatenate([np.diff(A.row_ptr[r0:r1 + 1]) for r0, r1 in spans])
    idx = np.concatenate([np.arange(A.row_ptr[r0], A.row_ptr[r1])
                          for r0, r1 in spans])
    crow = np.concatenate([[0], np.cumsum(counts)])
    return csr_tensor(torch, crow, A.col_index[idx], A.values[idx],
                      (counts.size, A.ncols), device)


def measure_records(torch, records) -> dict:
    """Replay, check and time each launch record (the first call of a
    record's kernel is the checked one); returns the per-kernel sums,
    bounds still to be set by :func:`set_bounds`."""
    stats = {}
    for rec in records:
        k, p = rec["kernel"](), rec["plain"]()
        torch.cuda.synchronize()
        rows = rec["rows"]
        if rows is not None:
            k, p = k[rows], p[rows.to(p.device)]
        k, p = k.double().cpu(), p.double().cpu()
        err = float((k - p).abs().max()) if k.numel() else 0.0
        what = f"{rec['name']} ({rec['family']}, {rec['pass_']}pass)"
        if rec["exact"]:
            check(torch.equal(k, p), f"{what} differs from its plain version")
        else:
            scale = rec["scale"]()
            scale = (scale[rows] if rows is not None else scale).double().cpu()
            bad = ~((k - p).abs() <= KERNEL_TOL * (1.0 + scale))   # NaN too
            check(not bool(bad.any()),
                  f"{what} disagrees with its plain version: max abs err "
                  f"{err} at rtol = atol = {KERNEL_TOL} on |A|.|x|")
        s = stats.setdefault(rec["name"], dict(
            ms=0.0, eager_ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0,
            max_abs_err=0.0, library_ms=None, families=[]))
        s["ms"] += graph_ms(torch, rec["kernel"])
        s["eager_ms"] += cuda_ms(torch, rec["kernel"])
        s["plain_ms"] += cuda_ms(torch, rec["plain_timed"])
        s["bytes"] += rec["bytes"]
        s["ops"] += rec["ops"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        if rec["family"] not in s["families"]:
            s["families"].append(rec["family"])
        if rec["library"] is not None:
            s["library_ms"] = (s["library_ms"] or 0.0) + cuda_ms(
                torch, rec["library"])
    return stats


def set_bounds(stats) -> dict:
    for s in stats.values():
        s["bound_ms"] = 1e3 * max(s["bytes"] / HBM_BYTES_PER_S,
                                  s["ops"] / FP32_FLOPS_PER_S)
        s["bound_by"] = ("bytes" if s["bytes"] / HBM_BYTES_PER_S
                         >= s["ops"] / FP32_FLOPS_PER_S else "operations")
    return stats


def measure_kernels(torch, prog, fn, xs, x_prog, device) -> dict:
    """Replay, check and time every kernel launch of one SpMV; returns the
    per-kernel sums for this program."""
    stats = measure_records(torch, replays(torch, fn, xs))
    # library yardsticks: one PyTorch call computing the same function
    lib_of = {"ell_spmv": ("ell", "hyb"), "seg_psum": ("seg", "split"),
              "tile_contrib": ("tile",)}
    x_col = torch.from_numpy(x_prog.astype(np.float32)).to(device)[:, None]
    for name, fams in lib_of.items():
        if name not in stats:
            continue
        total = 0.0
        for fam in fams:
            if fam in fn.families:
                A = family_csr(torch, prog, fn.families[fam].cpu(), device)
                total += cuda_ms(torch, lambda A=A: torch.sparse.mm(A, x_col))
        stats[name]["library_ms"] = total
    return set_bounds(stats)


#: The plan the autotuner picks for the full-size cop20k_A (the
#: reference's pick on the same matrix).
COP20K_PLAN = dict(layout="block", distribution="nonzero", reordering="bfs",
                   exchange="halo", kernel="seg", num_shards=8)


def phases(cop=None, cop_plan=None):
    """(label, matrix builder, [(plan label, plan)]) for the three phases.
    ``cop`` is the cop20k_A matrix and ``cop_plan`` the autotuner's plan
    for it, from the planner phase; by default the matrix is built anew
    and the plan is :data:`COP20K_PLAN`."""
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data import matrices as mats

    M = 131072
    cop_plan = cop_plan or SpmvPlan(**COP20K_PLAN)
    return [
        ("cop20k_A", (lambda: cop) if cop is not None
         else (lambda: mats.make_matrix("cop20k_A")), [
            ("cop20k_A/seg", cop_plan),
            ("cop20k_A/ell", SpmvPlan(layout="cyclic", exchange="allgather",
                                      kernel="ell", num_shards=8))]),
        ("blocked_band", lambda: mats.blocked_band(M, 32 * M, seed=0), [
            ("blocked_band", SpmvPlan(
                num_shards=8,
                shard_kernels=("tile", "tile", "tile", "ell", "hyb", "seg",
                               "split", "seg"),
                split_counts=(1, 1, 1, 1, 1, 1, 4, 1),
                shard_exchanges=("halo", "halo", "halo", "halo", "allgather",
                                 "halo", "halo", "allgather")))]),
        ("powerlaw_tail", lambda: mats.powerlaw_tail(M, 16 * M, n_monster=8,
                                                     seed=0), [
            ("powerlaw_tail", SpmvPlan(kernel="split", num_shards=8))]),
    ]


def answers_error(label, A, xs, ys) -> float:
    """The largest |A|·|x|-scaled error of the answers ``ys`` (float64,
    rows past A's padded out) against ``csr_matvec``; checks shapes and
    finiteness."""
    from repro_torch.core.sparse_matrix import csr_matvec

    absA = dataclasses.replace(A, values=np.abs(A.values))
    err = 0.0
    for x, got in zip(xs, ys):
        check(got.shape == (A.nrows,) + x.shape[1:]
              and np.isfinite(got).all(),
              f"{label}: output shape {got.shape} or non-finite values")
        scale = csr_matvec(absA, np.abs(x))
        err = max(err, float((np.abs(got - csr_matvec(A, x))
                              / (1.0 + scale)).max()))
    check(err <= E2E_TOL, f"{label}: scaled error {err} > {E2E_TOL}")
    return err


def planner_phase(torch, A, device, seed) -> tuple:
    """The host layer on the full-size cop20k_A: ``autotune`` with the
    default probe must pick :data:`COP20K_PLAN`; the Emu backend's
    ``cext`` and ``numpy`` engines must agree; ``relower`` to a plan with
    shards 0 and 1 on ``ell`` must share stages 2-7 and answer on the card
    bitwise as ``lower`` of that plan does; and a saved and reloaded
    program must answer on the card bitwise as the original.  Returns
    the choice and the phase's summary (host seconds)."""
    import tempfile

    from repro_torch.core import _emu_cext, artifacts, program as P
    from repro_torch.core.plan import autotune
    from repro_torch.core.spmv import SpmvPlan

    out = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        value = fn()
        out[key] = time.perf_counter() - t0
        return value

    choice = timed("autotune_s", lambda: autotune(A, num_shards=8))
    out["probed"] = choice.probed
    out["probe_engine"] = ("cext" if _emu_cext.load_kernel() is not None
                           else "numpy")
    out["plan"] = dataclasses.asdict(choice.plan)
    check(choice.plan == SpmvPlan(**COP20K_PLAN),
          f"planner: autotune picked {choice.plan}, not {COP20K_PLAN}")
    prog = timed("lower_s", lambda: P.lower(A, choice.plan))
    emu = {engine: timed(f"emu_{engine}_s", lambda e=engine: P.execute(
        prog, backend="emu", engine=e)) for engine in ("cext", "numpy")}
    a, b = emu["cext"], emu["numpy"]
    out["emu_engines_equal"] = bool(
        a.ticks == b.ticks and a.migrations == b.migrations
        and np.array_equal(a.instr_per_nodelet, b.instr_per_nodelet)
        and np.array_equal(a.residency, b.residency))
    check(out["emu_engines_equal"], "planner: the cext and numpy Emu "
                                    "engines disagree")
    out["emu_ticks"] = a.ticks

    plan2 = dataclasses.replace(choice.plan,
                                shard_kernels=("ell", "ell") + ("seg",) * 6)
    prog2 = timed("relower_s", lambda: P.relower(prog, plan2))
    out["relower_shares_2_to_7"] = all(
        prog2.stages[p] is prog.stages[p] for p in range(2, 8))
    check(out["relower_shares_2_to_7"]
          and prog2.shard_kernels()[:2] == ("ell", "ell"),
          "planner: relower shared or rebuilt the wrong stages")
    with tempfile.TemporaryDirectory() as tmp:
        timed("save_s", lambda: artifacts.save_program(
            prog, tmp, source=A, choice=choice))
        loaded, loaded_choice = timed(
            "load_s", lambda: artifacts.load_program(tmp, expect=A))
    check(loaded_choice.to_json() == choice.to_json(),
          "planner: the reloaded PlanChoice differs")

    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(A.ncols) for _ in range(4)] + \
        [rng.standard_normal((A.ncols, 8))]

    def answers(program):
        fn = P.make_program_spmv_fn(program, device=device)
        xo = [x if program.perm is None else P._apply_perm(x, program.perm)
              for x in xs]
        return [fn(torch.from_numpy(program.x_to_device(
            x.astype(np.float32))).to(device)) for x in xo]

    for label, got, want in (
            ("relower", prog2, P.lower(A, plan2)),
            ("reload", loaded, prog)):
        ys, ws = answers(got), answers(want)
        equal = all(torch.equal(y, w) for y, w in zip(ys, ws))
        check(equal, f"planner: the {label}ed program's answers differ on "
                     f"the card")
        out[f"{label}_bitwise"] = equal
        out[f"{label}_max_scaled_err"] = answers_error(
            f"planner/{label}", A, xs,
            [P.gather_b(got, y).astype(np.float64) for y in ys])
    return choice, out


def run_program(torch, label, A, plan, singles, block, device) -> dict:
    """Answer the requests, check them and measure the kernels."""
    from repro_torch.core import program as P
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    prog = P.lower(A, plan)
    fn = P.make_program_spmv_fn(prog, device=device)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0

    def prog_order(x):
        return x if prog.perm is None else P._apply_perm(x, prog.perm)

    def on_card(x):
        xs = prog.x_to_device(prog_order(x).astype(np.float32))
        return torch.from_numpy(xs).to(device)

    xs_single = [on_card(x) for x in singles]
    xs_block = on_card(block)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after --------
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    ys = [fn(xs) for xs in xs_single]
    y_block = fn(xs_block)
    torch.cuda.synchronize()
    requests_s = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    # -- checks --------------------------------------------------------------
    err = answers_error(label, A, singles + [block],
                        [P.gather_b(prog, y).astype(np.float64)
                         for y in ys + [y_block]])
    serial = P.make_program_spmv_fn(prog, device=device, pipeline=False)
    pipeline_bitwise = all(torch.equal(serial(xs), y)
                           for xs, y in zip(xs_single + [xs_block],
                                            ys + [y_block]))
    check(pipeline_bitwise, f"{label}: pipeline on/off differ")
    rerun_bitwise = all(torch.equal(fn(xs), y)
                        for xs, y in zip(xs_single + [xs_block],
                                         ys + [y_block]))
    check(rerun_bitwise, f"{label}: two runs differ")
    columns_bitwise = all(
        torch.equal(y_block[..., b], fn(xs_block[..., b].contiguous()))
        for b in range(xs_block.shape[-1]))
    check(columns_bitwise, f"{label}: a batched column differs from the "
                           f"per-vector call")
    # -- time per SpMV and per kernel ----------------------------------------
    spmv_ms = cuda_ms(torch, lambda: fn(xs_single[0]), 10)
    block_ms = cuda_ms(torch, lambda: fn(xs_block), 5)
    spmv_graph_ms = graph_ms(torch, lambda: fn(xs_single[0]), 10)
    block_graph_ms = graph_ms(torch, lambda: fn(xs_block), 10)
    kernels = measure_kernels(torch, prog, fn, xs_single[0],
                              prog_order(singles[0]), device)
    kernels_b8 = set_bounds(measure_records(torch, replays(torch, fn,
                                                           xs_block)))
    for name, s in kernels.items():
        s["launches"] = launches[name]
    for name, count in launches.items():
        if count and name not in kernels:
            raise CheckFailed(f"{label}: {name} launched but not replayed")
    return dict(phase=label, rows=A.nrows, nnz=A.nnz,
                shard_kernels=list(prog.shard_kernels()),
                lower_and_operands_s=lower_s, requests_s=requests_s,
                spmv_ms=spmv_ms, block8_ms=block_ms,
                spmv_graph_ms=spmv_graph_ms, block8_graph_ms=block_graph_ms,
                host_share=1.0 - spmv_graph_ms / spmv_ms, max_scaled_err=err,
                pipeline_bitwise=pipeline_bitwise,
                rerun_bitwise=rerun_bitwise,
                columns_bitwise=columns_bitwise, launches=launches,
                kernels=kernels, kernels_b8=kernels_b8)


#: The kernel wrappers the per-format API reaches, by their names in
#: ``repro_torch.kernels.ops``.
API_WRAPPERS = ("_ell_kernel", "seg_psum", "seg_fixup", "split_psum",
                "split_combine", "tile_walk_spmv")


@contextlib.contextmanager
def recorded_launches(ops):
    """Record every kernel wrapper call the per-format API makes, with its
    inputs, so each launch can be replayed."""
    calls = []
    saved = {name: getattr(ops, name) for name in API_WRAPPERS}

    def recorder(name, fn):
        def call(*args, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call
    for name, fn in saved.items():
        setattr(ops, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def popcount(m) -> int:
    """Set bits of a uint8 tensor."""
    v = m - ((m >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return int(((v + (v >> 4)) & 0x0F).sum())


def api_record(torch, label, wrapper, a, kw) -> dict:
    """One recorded launch of the per-format API as a replay record (the
    fields of :func:`family_replays`' records), bytes counted as there.

    The tile walk with a mask counts what it now reads: the mask (16 bytes
    a tile row), the occupied 32-byte sectors of data (a nonzero mask
    byte each), each distinct x sector the occupied sectors meet (32 bytes
    a column), ``tile_cols``, ``tile_ptr`` and y.  The earlier walk read,
    and this counted, every whole tile and every x lane of its block
    columns; the null-mask walk of the Block-ELL shims still does, and is
    counted so."""
    from repro_torch.kernels import spmv_ell, spmv_seg, spmv_split, spmv_tile

    dev = a[0].device
    rec = dict(family=label, pass_="", rows=None, exact=False, library=None)

    def fresh(shape, device=dev):
        return lambda: torch.empty(shape, device=device)

    if wrapper == "_ell_kernel":
        data, cols, orow, ocol, oval, optr, x, sids = a
        ell_len = kw.get("ell_len")
        S, R, W = data.shape
        B = x.shape[1]
        m = int(optr[0, R])
        out = fresh((S, B, R))
        if ell_len is None:                 # every slot of the slab is real
            real = torch.ones_like(cols, dtype=torch.bool)
        else:
            real = torch.arange(W, device=dev) < ell_len[..., None]
        n_slots = int(real.sum())
        gathered = torch.cat([cols[real], ocol[0, :m]])
        rec.update(
            name="ell_spmv",
            kernel=lambda: spmv_ell.ell_spmv(*a, ell_len=ell_len, out=out()),
            plain=lambda: spmv_ell.ell_spmv_plain(*a, out(), ell_len=ell_len),
            scale=lambda: spmv_ell.ell_spmv_plain(
                data.abs(), cols, orow, ocol, oval.abs(), optr, x.abs(), sids,
                out(), ell_len=ell_len),
            bytes=8 * n_slots + (0 if ell_len is None else 4 * R) + 8 * m
            + 4 * (R + 1) + 4 * B * distinct(torch, [gathered], shared=True)
            + 4 * B * R + 4,
            ops=2 * B * (n_slots + m))
    elif wrapper in ("seg_psum", "split_psum"):
        vals, cols, x = a[:3]
        B = x.shape[-2]
        mod = spmv_seg if wrapper == "seg_psum" else spmv_split
        kernel, plain = getattr(mod, wrapper), getattr(mod, wrapper + "_plain")
        rest = a[3:]                    # seg_psum's sids
        out = fresh(((len(rest[0]),) if rest else ()) + (B,)
                    + tuple(vals.shape[len(rest):]))
        rec.update(
            name=wrapper, kernel=lambda: kernel(*a),
            plain=lambda: plain(*a, out()),
            scale=lambda: plain(vals.abs(), cols, x.abs(), *rest, out()),
            bytes=nbytes(vals, cols)
            + 4 * B * distinct(torch, [cols.reshape(-1)], shared=True)
            + 4 * B * vals.numel() + 4 * len(rest),
            ops=2 * B * vals.numel())
    elif wrapper == "seg_fixup":
        psum, pcs, ptr = a[:3]
        _, B, _, L = psum.shape
        R, ns = ptr.shape[1] - 1, kw["num_splits"]
        m = int(ptr[0, R])
        chunk, lo, hi = pcs[0, :m, :3].long().unbind(1)
        live = lo <= hi
        read_at = torch.cat([(chunk * L + hi)[live],
                             (chunk * L + lo - 1)[live & (lo > 0)]])
        shape = kw["out"].shape
        cpu = [t.cpu() for t in a]
        rec.update(
            name="seg_fixup", exact=True,
            kernel=lambda: spmv_seg.seg_fixup(*a, num_splits=ns,
                                              out=fresh(shape)()),
            # CUDA's index_add_ has no fixed order: the exact check runs
            # the plain version on the CPU copies of the same inputs
            plain=lambda: spmv_seg.seg_fixup_plain(*cpu,
                                                   fresh(shape, "cpu")()),
            plain_timed=lambda: spmv_seg.seg_fixup_plain(*a, fresh(shape)()),
            scale=None,
            bytes=4 * B * distinct(torch, [read_at], shared=False) + 20 * m
            + 4 * (R + 1) + 8 + 4 * B * ns * R,
            ops=2 * B * m)
    elif wrapper == "split_combine":
        part, sids = a
        _, B, ns, R = part.shape
        out = fresh(kw["out"].shape)
        rec.update(
            name="split_combine", exact=True, scale=None,
            kernel=lambda: spmv_split.split_combine(part, sids, out=out()),
            plain=lambda: spmv_split.split_combine_plain(part, sids, out()),
            bytes=nbytes(part) + 4 * B * R + 4, ops=B * ns * R,
            library=lambda: part.sum(dim=2))
    elif wrapper == "tile_walk_spmv":
        data, tcols, tptr, x = a
        mask = kw.get("mask")
        T, bm, bn = data.shape
        B, n = x.shape
        out = fresh((B, (tptr.numel() - 1) * bm))
        if mask is None:
            lanes = int((n - tcols.unique().long() * bn).clamp(max=bn).sum())
            moved = nbytes(data) + 4 * B * lanes
            flops = 2 * B * data.numel()
        else:
            occ = mask != 0                   # (T, bm, bn/8) occupied sectors
            xsec = (tcols.long()[:, None] * (bn // 8)
                    + torch.arange(bn // 8, device=dev))[occ.any(1)]
            moved = (nbytes(mask) + 32 * int(occ.sum())
                     + 32 * B * int(xsec.unique().numel()))
            flops = 2 * B * popcount(mask)
        rec.update(
            name="tile_walk_spmv",
            kernel=lambda: spmv_tile.tile_walk_spmv(*a, mask=mask),
            plain=lambda: spmv_tile.tile_walk_spmv_plain(*a, out(),
                                                         mask=mask),
            scale=lambda: spmv_tile.tile_walk_spmv_plain(
                data.abs(), tcols, tptr, x.abs(), out(), mask=mask),
            bytes=moved + nbytes(tcols, tptr)
            + 4 * B * (tptr.numel() - 1) * bm,
            ops=flops)
    else:
        raise CheckFailed(f"{label}: no replay for {wrapper}")
    rec.setdefault("plain_timed", rec["plain"])
    return rec


def api_cases(torch, matrices, device):
    """(label, matrix, call) for the kernel_api phase, one at a time: each
    format is built on the host and its arrays moved to the card once;
    ``call(x)`` then runs the API on them for x (N,) or (N, B) on the
    card."""
    from repro_torch.core.sparse_matrix import csr_to_bcsr, csr_to_ell
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import ops

    def card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    tail = matrices["powerlaw_tail"]
    for label, ns, chunk in (("api/split8", 8, ops.SEG_CHUNK),
                             ("api/split64", 64, ops.SEG_CHUNK),
                             ("api/split64_4096", 64, 4096)):
        spl = ops.split_from_csr(tail, ns, chunk=chunk)
        arrays = card(spl.vals, spl.cols, spl.rows, spl.piece_split,
                      spl.piece_chunk, spl.piece_lo, spl.piece_hi,
                      spl.piece_row)
        yield label, tail, lambda x, a=arrays: ops.split_spmv(
            a, x, num_rows=tail.nrows, device=device)
    band = matrices["blocked_band"]
    for label, bm, bn in (("api/tile", 8, 128), ("api/tile16x64", 16, 64)):
        t = ops.tile_from_csr(band, bm=bm, bn=bn)
        data, tcols, tptr, tmask = card(t.data, t.tile_cols, t.tile_ptr,
                                        t.mask)
        t = dataclasses.replace(t, data=data, tile_cols=tcols, tile_ptr=tptr,
                                mask=tmask)
        yield label, band, lambda x, t=t: ops.tile_spmv(t, x, device=device)
    cop = matrices["cop20k_A"]
    for label, chunk in (("api/seg", ops.SEG_CHUNK), ("api/seg2048", 2048)):
        seg = ops.seg_from_csr(cop, chunk=chunk)
        arrays = card(seg.vals, seg.cols, seg.rows, seg.piece_chunk,
                      seg.piece_lo, seg.piece_hi, seg.piece_row)
        yield label, cop, lambda x, a=arrays: ops.seg_spmv(
            a, x, num_rows=cop.nrows, device=device)
    hyb = card(*(getattr(ops.hyb_from_csr(cop), f) for f in (
        "data", "cols", "overflow_rows", "overflow_cols", "overflow_vals")))
    yield "api/hyb", cop, lambda x: ops.hyb_spmv(*hyb, x, device=device)
    ell = csr_to_ell(cop)
    ell = card(ell.data, ell.cols)
    yield "api/ell", cop, lambda x: ops.ell_spmv(*ell, x, device=device)
    small = mats.blocked_band(16384, 32 * 16384, seed=0)
    bell = card(*ops.bell_from_bcsr(csr_to_bcsr(small, (8, 128))))
    yield "api/bell", small, lambda x: (
        ops.bell_spmv if x.dim() == 1 else ops.bell_spmm)(*bell, x,
                                                          device=device)


def run_api_call(torch, label, A, call, singles, block, device) -> dict:
    """Answer the requests through one per-format API call, check them and
    measure the kernels each call launches."""
    from repro_torch.kernels import _lib, ops

    xs = [torch.from_numpy(x.astype(np.float32)).to(device) for x in singles]
    xblk = torch.from_numpy(block.astype(np.float32)).to(device)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after --------
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    ys = [call(x) for x in xs]
    y_block = call(xblk)
    torch.cuda.synchronize()
    requests_s = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    # -- checks (rows past A's, ELL or block padding, must be zero) -------
    for y in ys + [y_block]:
        check(not y[A.nrows:].any(), f"{label}: padded rows are not zero")
    err = answers_error(label, A, singles + [block],
                        [y[:A.nrows].double().cpu().numpy()
                         for y in ys + [y_block]])
    rerun_bitwise = all(torch.equal(call(x), y)
                        for x, y in zip(xs + [xblk], ys + [y_block]))
    check(rerun_bitwise, f"{label}: two runs differ")
    columns_bitwise = all(torch.equal(y_block[:, b],
                                      call(xblk[:, b].contiguous()))
                          for b in range(xblk.shape[1]))
    check(columns_bitwise, f"{label}: a batched column differs from the "
                           f"per-vector call")
    # -- time per call and per kernel -----------------------------------------
    call_ms = cuda_ms(torch, lambda: call(xs[0]), 10)
    block_ms = cuda_ms(torch, lambda: call(xblk), 5)
    with recorded_launches(ops) as calls:
        call(xs[0])
    kernels = measure_records(torch, [api_record(torch, label, *c)
                                      for c in calls])
    with recorded_launches(ops) as calls:
        call(xblk)
    kernels_b8 = set_bounds(measure_records(torch, [
        api_record(torch, label, *c) for c in calls]))
    A_card = csr_tensor(torch, A.row_ptr, A.col_index, A.values, A.shape,
                        device)
    for name in ("ell_spmv", "seg_psum", "split_psum", "tile_walk_spmv"):
        if name in kernels:
            kernels[name]["library_ms"] = cuda_ms(
                torch, lambda: torch.sparse.mm(A_card, xs[0][:, None]))
    set_bounds(kernels)
    for name, s in kernels.items():
        s["launches"] = launches[name]
    for name, count in launches.items():
        if count and name not in kernels:
            raise CheckFailed(f"{label}: {name} launched but not replayed")
    return dict(phase=label, rows=A.nrows, nnz=A.nnz, requests_s=requests_s,
                call_ms=call_ms, block8_ms=block_ms, max_scaled_err=err,
                rerun_bitwise=rerun_bitwise, columns_bitwise=columns_bitwise,
                launches=launches, kernels=kernels, kernels_b8=kernels_b8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _lib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lib.lib()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "compile_s": _lib.build_info.get("seconds"),
                      "ptxas": [ln.strip() for ln in _lib.build_info.get(
                          "ptxas", "").splitlines() if "Used" in ln]}))

    from repro_torch.data import matrices as mats

    t0 = time.perf_counter()
    cop = mats.make_matrix("cop20k_A")
    cop_s = time.perf_counter() - t0
    # its own generator, so the later phases' inputs stay as they were
    choice, planner = planner_phase(torch, cop, device, args.seed + 1)
    planner["matrix_s"] = cop_s
    print(json.dumps({"planner": planner}))

    rng = np.random.default_rng(args.seed)
    results, totals, matrices = {}, {name: 0 for name in _lib.KERNELS}, {}
    for label, build, plans in phases(cop, choice.plan):
        t0 = time.perf_counter()
        A = build()
        gen_s = time.perf_counter() - t0
        singles = [rng.standard_normal(A.ncols) for _ in range(4)]
        block = rng.standard_normal((A.ncols, 8))
        for plan_label, plan in plans:
            r = run_program(torch, plan_label, A, plan, singles, block,
                            device)
            r["matrix_s"] = gen_s
            results[plan_label] = r
            for name, count in r["launches"].items():
                totals[name] += count
            print(json.dumps(r))
        matrices[label] = A
    # the per-format kernel API; the bell_* shims warn once by design
    warnings.filterwarnings("ignore", message="bell_",
                            category=DeprecationWarning)
    for label, A, call in api_cases(torch, matrices, device):
        singles = [rng.standard_normal(A.ncols) for _ in range(4)]
        block = rng.standard_normal((A.ncols, 8))
        r = run_api_call(torch, label, A, call, singles, block, device)
        results[label] = r
        for name, count in r["launches"].items():
            totals[name] += count
        print(json.dumps(r))
    summary = []
    for name in _lib.KERNELS:
        check(totals[name] > 0, f"{name} was never launched on the main path")
        phase = HEADLINE[name]
        s = results[phase]["kernels"][name]
        summary.append(dict(
            name=name, route="cuda", source=SOURCE[name],
            replaces=REPLACES[name], launches=totals[name],
            max_abs_err=max(r["kernels"][name]["max_abs_err"]
                            for r in results.values() if name in r["kernels"]),
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            phase=phase, ms_b8=results[phase]["kernels_b8"][name]["ms"],
            bound_ms_b8=results[phase]["kernels_b8"][name]["bound_ms"]))
        if name == "seg_fixup":
            summary[-1]["note"] = ("the carry fix-up is jnp glue in the "
                                   "reference, not a pallas_call")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
