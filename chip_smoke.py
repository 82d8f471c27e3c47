#!/usr/bin/env python3
"""Drive the port's sparse device path and its LM serving and training
paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # the full run, one card

Builds the CUDA kernels from ``src/repro_torch/csrc``, then runs a
``planner`` phase on the host, three phases through the executor's entry
points (``lower``, ``make_program_spmv_fn``, ``gather_b``), a
``kernel_api`` phase through the per-format kernel API
(``repro_torch.kernels``), a ``serving`` phase through the router
(``repro_torch.serve``), an ``lm_serve`` phase through the LM
``Engine``, an ``lm_train`` phase through ``make_train_step`` and
``train_loop``, an ``lm_train_sharded`` phase through the sharded
step on a ``torch.distributed`` mesh, and an ``examples`` phase through
the six scripts of ``examples_torch/``:

* ``planner``: ``autotune(make_matrix("cop20k_A"), num_shards=8)`` at
  the full Table-I size (120,000 rows) with the default probe must pick
  ``bfs/block/nonzero/halo/seg``; ``execute(prog, backend="emu")`` on
  that program with the ``cext`` and ``numpy`` engines must give equal
  ``EmuResult``s; ``relower`` to a plan with shards 0 and 1 on ``ell``
  must keep stages 2-7 as the same objects and answer on the card
  bitwise as ``lower`` of that plan does; a program saved with
  ``save_program`` and read back with ``load_program`` must answer on
  the card bitwise as the original.  Both pass the |A|·|x|-scaled
  check below.  Prints one ``{"planner": ...}`` line of host seconds.
  The bundle stays for the serving phase;
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
  495 MB), so the shim runs at an eighth of the rows;
* ``serving``: one ``SparseMatrixEngine(num_shards=8)`` on the card with
  micro-batches of up to 8 requests (2 ms linger) and three tenants at
  the sizes above: cop20k_A warm-started from the planner's bundle
  (``warm_start`` checked: no second autotune), blocked_band under its
  mixed plan and powerlaw_tail under ``split``, so requests reach
  ``ell_spmv``, ``seg_psum``, the fix-up, ``split_combine`` and
  ``tile_contrib`` through graph-replayed executors.  8 client threads
  send 32 single vectors each, round-robin over the tenants (x from a
  seeded generator), then one (N, 8) block per tenant.  Every answer
  must be within the |A|·|x|-scaled 2e-4 of a float64 product (held to
  ``csr_matvec``), bitwise the tenant's solo call and bitwise an eager
  executor's (``graphs=False``) on the same program.  A second engine
  (4 shards, ``make_matrix("cop20k_A", scale=0.005)``) takes
  ``tests/test_rebalance.py``'s drifting stream and must swap a program
  in, served by its own executor and passing the same check.  Prints one
  ``{"serving": ...}`` line: per tenant p50/p99 wall ms per request
  (host included), set-up seconds (operand upload plus captures), graph
  shapes held and their device memory; requests/s over the threaded
  stream, micro-batch sizes, swaps, one thread's solo-call p50 and the
  wall ms of a batch's host steps at B = 1, 3, 8 (``host_path_ms``).
  Its launch counts are the warm-up calls and captures (replays launch
  uncounted) and stay out of the kernels line;
* ``lm_serve``: qwen3-4b at its published size (36 layers, 4.411 B
  parameters in bf16, from a seeded CUDA generator) serves 4 requests of
  8 prompt and 16 new tokens through ``Engine.generate``; a second
  ``generate`` must give bitwise the same tokens; the engine's steps are
  replayed through ``decode_step`` under CUDA events (stepped prefill ms
  a token, median decode ms a step, one step replayed as a CUDA graph,
  beside the bound: weight and cache bytes over 3.35 TB/s); a
  teacher-forced ``forward`` over the (4, 24) tokens must agree with the
  decode logits within the reference's decode-vs-forward tolerance (0.15
  rtol and atol), each greedy token must be its argmax but at near-ties
  (counted), ``prefill`` must equal its last position, all logits
  finite.  Then every arch at its published widths, depth cut to one
  pattern unit plus the dense-first layers (``reduced``), runs the same
  checks over 4 new tokens (MoE archs on f32 parameters at a dropless
  capacity, as the reference's decode check; xLSTM's comparison held on
  one mLSTM and one sLSTM block, ``LM_HELD_ON``), freeing the card
  between archs.  The LM path must launch none of the sparse kernels.
  Prints one ``{"lm_serve": ...}`` line;
* ``lm_train``: with the earlier phases' memory released, qwen3-4b at
  its published size (random weights from a seeded CUDA generator) with
  AdamW state on top takes a warm-up step, a step under the ATen op
  counter and 4 steps under CUDA events through ``make_train_step``
  (remat on, grad_accum 1) on ``TokenStream`` batches of 4 x 512 tokens,
  beside the bound (``train_bound_ms``): every loss and gnorm finite,
  ``lr`` equal to ``schedule``, the step-0 loss equal to a separate
  ``loss_fn`` within ``TRAIN_LOSS_SELF_TOL``, the loss on step 0's batch
  lower after the steps, peak memory under the card's.  Then every arch
  at its published widths cut to one pattern unit (``reduced``) takes 2
  steps at grad_accum 2, but those whose AdamW state with f32
  accumulators exceeds the card (listed under ``skipped`` with their
  bytes); then qwen3-4b cut to one layer takes one step on the card and
  one on the CPU from the same weights and batch (loss, gnorm, m, v, the
  parameters and the share of them more than an ulp apart within
  ``CARD_CPU_TOL``, the CPU tests' tolerances),
  and 4 steps through ``train_loop`` with a checkpoint after step 2,
  resumed through ``elastic.resume`` (steps 2-3's losses within
  ``RESTART_RTOL``).  The training path must launch none of the sparse
  kernels.  Prints one ``{"lm_train": ...}`` line;
* ``lm_train_sharded``: a world-size-1 NCCL process group (a
  ``FileStore`` in a temporary directory) and the port's host mesh over
  it, (1, 1); qwen3-4b at its published size with ``fsdp=True`` takes
  ``lm_train``'s six steps (the same seed, batches and schedule) through
  the sharded step (per-unit gathers, reduce-scattered gradients, the
  global norm), every loss, gnorm and lr held to ``lm_train``'s within
  ``CARD_CPU_TOL`` (``bitwise`` says whether they are equal), ms a
  step, ATen ops a step and peak memory beside ``lm_train``'s; then
  ``launch/dryrun.py`` over its whole grid on both production meshes
  (no cell may fail).  No fallback: a failed group or collective fails
  the run; no sparse kernel may launch.  Prints one
  ``{"lm_train_sharded": ...}`` line;
* ``examples``: each script's ``main`` on the card, its printout sent to
  stderr: ``quickstart`` and ``reorder_study`` (host only) return their
  tables; ``autotune_serve`` serves its four tenants through the
  graph-replayed router (every scaled error <= 2e-4; the SpMV kernels
  it launched, warm-ups and captures, are listed and stay out of the
  kernels line); ``serve_lm``'s prompts come back unchanged and each
  generated token's logit in a forward pass over the served tokens lies
  within 0.15 of its position's maximum; ``moe_valiant``'s expert load
  sums to T top_k and equals the CPU's on the same inputs, but where a
  route parts at a near-tie (the gap within the float32 rounding bound
  of the router's dot products); ``train_lm`` at its defaults (24.0M
  parameters, B = 8, S = 256, grad_accum 2) takes
  ``EXAMPLE_TRAIN_STEPS`` steps: losses and gnorms finite, the last 10
  losses' mean below the first 10's, four checkpoints, ms a step.
  Prints one ``{"examples": ...}`` line with each script's ``phase_s``.

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
import os
import subprocess
import sys
import tempfile
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


def planner_phase(torch, A, device, seed, bundle) -> tuple:
    """The host layer on the full-size cop20k_A: ``autotune`` with the
    default probe must pick :data:`COP20K_PLAN`; the Emu backend's
    ``cext`` and ``numpy`` engines must agree; ``relower`` to a plan with
    shards 0 and 1 on ``ell`` must share stages 2-7 and answer on the card
    bitwise as ``lower`` of that plan does; and a program saved to
    ``bundle`` and reloaded must answer on the card bitwise as the
    original (the serving phase warm-starts from that bundle).  Returns
    the choice and the phase's summary (host seconds)."""
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
    timed("save_s", lambda: artifacts.save_program(
        prog, bundle, source=A, choice=choice))
    loaded, loaded_choice = timed(
        "load_s", lambda: artifacts.load_program(bundle, expect=A))
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
    format is built on the host and its arrays moved to the card once (a
    SegMatrix, SplitMatrix or TileMatrix by its first call, which keeps
    them with its piece table); ``call(x)`` then runs the API on them for
    x (N,) or (N, B) on the card."""
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
        yield label, tail, lambda x, spl=spl: ops.split_spmv(
            spl, x, device=device)
    band = matrices["blocked_band"]
    for label, bm, bn in (("api/tile", 8, 128), ("api/tile16x64", 16, 64)):
        t = ops.tile_from_csr(band, bm=bm, bn=bn)
        yield label, band, lambda x, t=t: ops.tile_spmv(t, x, device=device)
    cop = matrices["cop20k_A"]
    for label, chunk in (("api/seg", ops.SEG_CHUNK), ("api/seg2048", 2048)):
        seg = ops.seg_from_csr(cop, chunk=chunk)
        yield label, cop, lambda x, seg=seg: ops.seg_spmv(
            seg, x, device=device)
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


#: The kernels the serving phase must reach through the router.
SERVING_KERNELS = ("ell_spmv", "seg_psum", "seg_fixup", "split_combine",
                   "tile_contrib")
CLIENTS, REQUESTS_PER_CLIENT = 8, 32


def f64_oracle(torch, A, X, device):
    """(A @ X, |A| @ |X|) in float64 for an (N, k) block, on the card: a
    float64 CSR product stands in for ``csr_matvec`` at serving volume,
    and is held to it on the block's first column."""
    from repro_torch.core.sparse_matrix import csr_matvec

    warnings.filterwarnings("ignore", message="Sparse")

    def prod(vals, x):
        M = torch.sparse_csr_tensor(
            torch.from_numpy(A.row_ptr.astype(np.int64)),
            torch.from_numpy(A.col_index.astype(np.int64)),
            torch.from_numpy(vals.astype(np.float64)), size=A.shape,
            device=device)
        return torch.sparse.mm(M, torch.from_numpy(x).to(device)).cpu() \
            .numpy()
    y, scale = prod(A.values, X), prod(np.abs(A.values), np.abs(X))
    want = csr_matvec(A, X[:, 0])
    check(np.abs(y[:, 0] - want).max() <= 1e-9 * (1.0 + scale[:, 0].max()),
          "serving: the float64 oracle disagrees with csr_matvec")
    return y, scale


def scaled_error(torch, label, A, xs, ys, device) -> float:
    """The largest |A|·|x|-scaled error of the answers ``ys`` to ``xs``
    (vectors, or (N, B) blocks), checked against :data:`E2E_TOL`."""
    X = np.concatenate([x.reshape(A.ncols, -1) for x in xs], axis=1)
    Y = np.concatenate([y.reshape(A.nrows, -1) for y in ys], axis=1)
    check(Y.shape == (A.nrows, X.shape[1]) and np.isfinite(Y).all(),
          f"{label}: answers of shape {Y.shape} or non-finite")
    err = 0.0
    for c in range(0, X.shape[1], 64):
        want, scale = f64_oracle(torch, A, X[:, c:c + 64], device)
        ratio = np.abs(Y[:, c:c + 64] - want) / (1.0 + scale)
        check(np.isfinite(ratio).all(),
              f"{label}: {int((~np.isfinite(want)).sum())} non-finite "
              f"oracle entries, {int((~np.isfinite(scale)).sum())} scales")
        err = max(err, float(ratio.max()))
    check(err <= E2E_TOL, f"{label}: scaled error {err} > {E2E_TOL}")
    return err


def host_path_ms(torch, run, xs, iters: int = 10) -> dict:
    """One thread's wall ms for the steps of a served batch of the vectors
    ``xs`` (what the micro-batcher and ``device_spmv`` do): ``stack`` (the
    batcher's (N, B) block), ``permute`` (float32, into the program's
    order, to the (S, per, B) layout), ``run`` (x copied in, the graph
    replayed, y copied out on the card, synchronised) and ``gather`` (y
    to the host and into the caller's order)."""
    from repro_torch.core import program as P

    prog = run.program
    parts = dict(stack=0.0, permute=0.0, run=0.0, gather=0.0)
    for _ in range(iters):
        t0 = time.perf_counter()
        X = np.stack(xs, axis=1)
        t1 = time.perf_counter()
        xp = X.astype(np.float32)
        if prog.perm is not None:
            xp = P._apply_perm(xp, prog.perm)
        xs_dev = prog.x_to_device(xp)
        t2 = time.perf_counter()
        y = run(xs_dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        P.gather_b(prog, y)
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key] += dt * 1e3 / iters
    return parts


def drift_request(rng, N, k, cols=None):
    """One request of ``tests/test_rebalance.py``'s drifting stream: k
    random entries of x, anywhere or among ``cols``."""
    x = np.zeros(N)
    idx = rng.integers(0, N, k) if cols is None else rng.choice(cols, size=k)
    x[idx] = rng.standard_normal(k)
    return x


def serving_phase(torch, matrices, tenant_plans, artifact_dir, device,
                  seed) -> dict:
    """``repro_torch.serve`` on the card: three tenants behind one
    micro-batching engine (cop20k_A warm-started from the planner phase's
    bundle), 8 client threads of 32 single-vector requests each,
    round-robin over the tenants, then one (N, 8) block per tenant; every
    answer within the scaled tolerance, bitwise the tenant's solo call
    and an eager executor's on the same program.  Then one rebalance
    swap on a second engine, at ``tests/test_rebalance.py``'s size.
    Launch counts here are the executors' warm-up calls and captures:
    graph replays launch without counting."""
    import threading

    from repro_torch.core import program as P
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import _lib
    from repro_torch.serve import MicroBatchConfig, RebalanceConfig, \
        SparseMatrixEngine

    out = {}
    eng = SparseMatrixEngine(num_shards=8, artifact_dir=artifact_dir,
                             micro_batch=MicroBatchConfig(max_batch=8,
                                                          max_wait_ms=2.0),
                             device=device)
    names = list(tenant_plans)
    tenants = {}
    torch.cuda.synchronize()
    # -- the serving path, ingest (executors built, micro-batch shapes
    # captured) to the last answer: counts zeroed just before, read just
    # after -------------------------------------------------------------------
    _lib.reset_launch_counts()
    for name in names:
        t0 = time.perf_counter()
        eng.ingest(name, matrices[name], plan=tenant_plans[name])
        tenants[name] = {"ingest_s": time.perf_counter() - t0}
    stats = eng.stats()
    check(stats["cop20k_A"]["warm_start"] and eng.warm_starts == 1,
          "serving: cop20k_A did not warm-start from the planner's bundle")

    rng = np.random.default_rng(seed)
    work = [[(names[(c + i) % len(names)],
              rng.standard_normal(matrices[names[(c + i) % len(names)]]
                                  .ncols))
             for i in range(REQUESTS_PER_CLIENT)] for c in range(CLIENTS)]
    answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
    walls = [[0.0] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
    errors = []
    barrier = threading.Barrier(CLIENTS + 1)

    def client(c):
        try:
            barrier.wait(timeout=60)
            for i, (name, x) in enumerate(work[c]):
                t0 = time.perf_counter()
                answers[c][i] = eng.spmv(name, x)
                walls[c][i] = time.perf_counter() - t0
        except BaseException as err:     # reported after the join
            errors.append(err)
            raise

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    stream_s = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"serving: a client failed or hung: {errors}")
    blocks = {name: rng.standard_normal((matrices[name].ncols, 8))
              for name in names}
    block_answers = {name: eng.spmv(name, X) for name, X in blocks.items()}
    torch.cuda.synchronize()
    launches = dict(_lib.launch_counts)
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"serving: {name} was never reached")
    out["launches"] = launches
    out["requests_per_s"] = CLIENTS * REQUESTS_PER_CLIENT / stream_s
    out["stream_s"] = stream_s

    # -- checks ----------------------------------------------------------------
    stats = eng.stats()
    for name in names:
        A = matrices[name]
        idx = [(c, i) for c in range(CLIENTS)
               for i in range(REQUESTS_PER_CLIENT) if work[c][i][0] == name]
        xs = [work[c][i][1] for c, i in idx]
        ys = [answers[c][i] for c, i in idx]
        m = eng._matrices[name]
        eager = P.make_program_spmv_fn(m.dist, device=device)
        solo, solo_ms = [], []
        for x in xs:
            t0 = time.perf_counter()
            solo.append(eng.spmv(name, x))
            solo_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.array_equal(y, z) for y, z in zip(ys, solo)),
              f"serving/{name}: a micro-batched answer differs from the "
              f"solo call")
        check(all(np.array_equal(y, P.device_spmv(eager, x))
                  for x, y in zip(xs, ys)),
              f"serving/{name}: a replayed answer differs from the eager "
              f"executor")
        check(np.array_equal(block_answers[name],
                             P.device_spmv(eager, blocks[name])),
              f"serving/{name}: the replayed block differs from the eager "
              f"executor")
        err = scaled_error(torch, f"serving/{name}", A,
                           xs + [blocks[name]], ys + [block_answers[name]],
                           device)
        w = np.array([walls[c][i] for c, i in idx]) * 1e3
        ex = stats[name]["executor"]
        mb = stats[name]["micro_batch"]
        tenants[name].update(
            requests=len(idx), p50_ms=float(np.percentile(w, 50)),
            p99_ms=float(np.percentile(w, 99)), max_ms=float(w.max()),
            build_s=ex["build_s"],
            capture_s=sum(g["capture_s"] for g in ex["graphs"]),
            setup_s=ex["build_s"] + sum(g["capture_s"] for g in ex["graphs"]),
            graphs=len(ex["graphs"]),
            graph_bytes=sum(g["bytes"] for g in ex["graphs"]),
            replays=sum(g["replays"] for g in ex["graphs"]),
            solo_p50_ms=float(np.median(solo_ms)),
            host_path_ms={f"B={b}": host_path_ms(torch, m.executor, xs[:b])
                          for b in (1, 3, 8)},
            mean_batch=mb["requests"] / max(mb["batches"], 1),
            widest=mb["widest"], max_scaled_err=err,
            shard_kernels=stats[name]["shard_kernels"],
            warm_start=stats[name]["warm_start"])
    out["tenants"] = tenants
    out["graph_bytes"] = sum(t["graph_bytes"] for t in tenants.values())
    out["mean_batch"] = float(np.mean([t["mean_batch"]
                                       for t in tenants.values()]))
    del eng

    # -- one rebalance swap, at tests/test_rebalance.py's size -----------------
    A = mats.make_matrix("cop20k_A", scale=0.005)
    cfg = RebalanceConfig(window=32, patience=2, cooldown=2, probe=2)
    eng = SparseMatrixEngine(num_shards=4, rebalance=cfg, device=device)
    eng.ingest("a", A)
    m = eng._matrices["a"]
    first = m.executor
    d = m.dist
    order = np.arange(A.ncols) if d.perm is None else d.perm
    hot = np.flatnonzero(d.x_layout.owner_of(order) == 0)
    rng = np.random.default_rng(0)
    k = max(A.ncols // 20, 8)
    xs = [drift_request(rng, A.ncols, k) for _ in range(2 * cfg.window)] + \
        [drift_request(rng, A.ncols, k, hot) for _ in range(10 * cfg.window)]
    ys, after = [], []
    for x in xs:
        ys.append(eng.spmv("a", x))
        if any(e.swapped for e in m.rebalance_log):
            after.append(m.executor.program is m.dist)
    swaps = sum(e.swapped for e in m.rebalance_log)
    check(swaps >= 1 and after and all(after) and m.executor is not first,
          "serving: the drifting stream swapped no program in, or the new "
          "program is not served by its own executor")
    out["swap"] = dict(
        swaps=swaps, trips=m.monitor.trips, requests_after_swap=len(after),
        new_plan=dataclasses.asdict(eng.plan("a")),
        max_scaled_err=scaled_error(torch, "serving/swap", A, xs, ys,
                                    device))
    return out


#: The LM serving phase: requests, prompt and generated tokens, the
#: reference's decode-vs-forward tolerance (rtol = atol,
#: ``tests/test_models.py``), the full-size arch and the depth-cut arches'
#: new tokens.
LM_BATCH, LM_PROMPT, LM_GEN, LM_CUT_GEN = 4, 8, 16, 4
LM_TOL = 0.15
LM_FULL_ARCH = "qwen3_4b"
#: Archs whose decode and forward logits part at their published widths in
#: the reference as well (xLSTM: by 1.17 within three tokens over one
#: 8-layer unit, ``repro.models`` on the CPU; one mLSTM and one sLSTM
#: block agree within 0.004), so the two are held to each other on one
#: block of each kind and only recorded over the whole unit.
LM_HELD_ON = {"xlstm_1_3b": ("mlstm", "slstm")}


def lm_cut(cfg):
    """One pattern unit plus the dense-first layers, at full width."""
    return dataclasses.replace(
        cfg, num_layers=cfg.dense_first_layers + len(cfg.pattern()))


def lm_excess(got, want) -> float:
    """How far |got - want| passes atol + rtol |want| (<= 0: within)."""
    return float(((got - want).abs() - LM_TOL * (1 + want.abs())).max())


def aten_ops(torch, fn) -> int:
    """The ATen ops ``fn`` dispatches, views not counted: about one kernel
    launch each."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


@contextlib.contextmanager
def recorded_routes():
    """The expert ids ``moe.route`` picks, call by call."""
    from repro_torch.models import moe
    calls, real = [], moe.route

    def route(params, x2d, cfg):
        weights, ids, zloss = real(params, x2d, cfg)
        calls.append(ids)
        return weights, ids, zloss
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def routes_agree(torch, dec_routes, fwd_routes, B, S, device):
    """(B, S) bool: the positions before each row's first route flip, where
    every MoE layer chose the same experts stepping as in the forward.  A
    flip moves that token's output by a whole expert's share, and its KV
    every later position in the row."""
    same = torch.ones((B, S), dtype=torch.bool, device=device)
    L = len(fwd_routes)
    check(len(dec_routes) == L * S, "one route a MoE layer a step")
    for layer, f in enumerate(fwd_routes):
        f = f.sort(dim=-1).values.reshape(B, S, -1)
        d = torch.stack([dec_routes[t * L + layer].sort(dim=-1).values
                         for t in range(S)], dim=1)
        same &= (f == d).all(dim=-1)
    return same.cumprod(dim=1).bool()


def lm_model_run(torch, cfg, device, seed, gen, *, timing=False,
                 hold=True) -> dict:
    """Build ``cfg`` from a seeded generator on the card, serve LM_BATCH
    prompts of LM_PROMPT tokens through ``Engine`` (twice: bitwise equal
    tokens), replay its steps through ``decode_step`` under CUDA events,
    and hold the decode logits to a teacher-forced ``forward`` over the
    served tokens, the greedy tokens to its argmax (but at near-ties) and
    ``prefill`` to its last position.  MoE archs carry f32 parameters at a
    dropless capacity, as the reference's own decode check does (bf16
    activations can flip a near-tied expert choice between the paths).
    ``hold=False`` records the decode-vs-forward comparisons unchecked."""
    from repro_torch.models import model as mm
    from repro_torch.models import params as pp
    from repro_torch.serve import Engine, ServeConfig

    B, P = LM_BATCH, LM_PROMPT
    max_len = P + gen + 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = pp.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
        params = pp.tree_map(lambda t: t.float(), params)
    torch.cuda.synchronize()
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               params=cfg.param_count(), init_s=time.perf_counter() - t0)
    weight_bytes = nbytes(*pp.tree_leaves(params))
    out["weights_gb"] = weight_bytes / 1e9
    eng = Engine(cfg, params, ServeConfig(max_len=max_len), device=device)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    t0 = time.perf_counter()
    served = eng.generate(prompts, gen)
    out["generate_s"] = time.perf_counter() - t0
    check(served.shape == (B, P + gen) and
          np.array_equal(served[:, :P], prompts), f"{cfg.name}: served shape")
    check(np.array_equal(eng.generate(prompts, gen), served),
          f"{cfg.name}: a second generate gave other tokens")

    # the engine's steps again, timed, keeping their logits
    toks = torch.as_tensor(served, dtype=torch.long, device=device)
    caches = mm.init_cache(cfg, B, max_len, device=device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(P + gen)]
    seen = []
    with torch.inference_mode(), recorded_routes() as dec_routes:
        events[0].record()
        for t in range(P + gen - 1):
            logits, caches = mm.decode_step(params, cfg, toks[:, t: t + 1],
                                            caches, t)
            seen.append(logits[:, 0])
            events[t + 1].record()
        torch.cuda.synchronize()
    with torch.inference_mode():
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(P + gen - 1)]
        dec = torch.stack(seen, dim=1)            # (B, P+gen-1, [K,] V)
        head_d = dec[:, :, 0] if cfg.num_codebooks > 1 else dec
        check(torch.equal(head_d[:, P - 1:].argmax(dim=-1), toks[:, P:]),
              f"{cfg.name}: replayed steps chose other tokens")
        check(bool(torch.isfinite(dec).all()), f"{cfg.name}: decode logits")

        # teacher-forced forward over the served tokens
        fcfg, ids = cfg, toks[:, :-1]
        if cfg.frontend == "encodec_stub":
            batch = {"frames": params["embed"][ids].to(torch.bfloat16)
                     * mm.embed_scale(cfg)}
        elif cfg.frontend == "siglip_stub":
            # the engine serves text with no image: a zero-length prefix
            fcfg = dataclasses.replace(cfg, prefix_len=0)
            batch = {"image_embeds": torch.zeros(
                (B, 0, cfg.d_model), dtype=torch.bfloat16, device=device),
                "tokens": ids}
        else:
            batch = {"tokens": ids}
        with recorded_routes() as fwd_routes:
            full, _ = mm.forward(params, fcfg, batch)
        check(full.shape == dec.shape and bool(torch.isfinite(full).all()),
              f"{cfg.name}: forward logits")
        # MoE: held up to each row's first route flip (bf16 attention
        # probabilities in decode move a near-tied expert choice)
        ok = routes_agree(torch, dec_routes, fwd_routes, B, P + gen - 1,
                          device)
        check(bool(ok[:, 0].all()), f"{cfg.name}: routes at position 0")
        if fwd_routes:
            out["positions_held"] = [int(ok.sum()), ok.numel()]
        diff = (dec - full).abs()
        out["max_abs_decode_vs_forward"] = float(diff.max())
        over = diff - LM_TOL * (1 + full.abs())
        over = over.reshape(B, P + gen - 1, -1).amax(dim=-1)
        out["max_abs_decode_vs_forward_held"] = float(
            diff.reshape(B, P + gen - 1, -1).amax(dim=-1)[ok].max())
        check(not hold or float(over[ok].max()) <= 0,
              f"{cfg.name}: decode logits off the forward's by "
              f"{out['max_abs_decode_vs_forward_held']}")
        # greedy tokens against the forward's argmax, but at near-ties:
        # top-2 within twice the row's |decode - forward| of each other
        head_f = full[:, :, 0] if cfg.num_codebooks > 1 else full
        head_f, head_d = head_f[:, P - 1:], head_d[:, P - 1:]
        top2 = head_f.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) <= \
            2 * (head_d - head_f).abs().amax(dim=-1)
        differ = (head_f.argmax(dim=-1) != toks[:, P:]) & ok[:, P - 1:]
        check(not hold or not bool((differ & ~near).any()),
              f"{cfg.name}: a greedy token is not the forward's argmax")
        out["near_ties"] = int(near.sum())
        out["greedy_off_forward_argmax"] = int(differ.sum())
        last = mm.prefill(params, fcfg, batch)
        out["max_abs_prefill_vs_forward"] = float(
            (last - full[:, -1:]).abs().max())
        check(lm_excess(last, full[:, -1:]) <= 0 and
              bool(torch.isfinite(last).all()), f"{cfg.name}: prefill")
        if cfg.frontend == "siglip_stub":
            # the prefix-LM path at full width: 256 image tokens
            img = torch.randn((1, cfg.prefix_len, cfg.d_model),
                              generator=torch.Generator(device=device)
                              .manual_seed(seed), device=device)
            full_img, _ = mm.forward(params, cfg, {
                "image_embeds": img.to(torch.bfloat16), "tokens": ids[:1]})
            check(full_img.shape == (1, cfg.prefix_len + ids.shape[1],
                                     cfg.vocab_size) and
                  bool(torch.isfinite(full_img).all()),
                  f"{cfg.name}: image-prefix forward")
            out["image_prefix_tokens"] = cfg.prefix_len

        if timing:
            out["prefill_ms_per_token"] = sum(step_ms[:P]) / P
            out["decode_ms"] = float(np.median(step_ms[P:]))
            out["decode_ms_all"] = step_ms[P:]
            out["tokens_per_s"] = B * 1000.0 / out["decode_ms"]
            cache_bytes = nbytes(*pp.tree_leaves(caches))
            out["cache_mb"] = cache_bytes / 1e6
            # each weight and cache byte read once a step
            out["decode_bound_ms"] = (weight_bytes + cache_bytes) \
                / HBM_BYTES_PER_S * 1e3
            # one step replayed as a CUDA graph: the card's own share
            tok = toks[:, P: P + 1]
            out["decode_ops"] = aten_ops(
                torch, lambda: mm.decode_step(params, cfg, tok, caches, P))
            out["decode_graph_ms"] = graph_ms(
                torch, lambda: mm.decode_step(params, cfg, tok, caches, P),
                iters=10)
    return out


def lm_serve_phase(torch, device, seed) -> dict:
    """The LM serving path: ``LM_FULL_ARCH`` at its published size, then
    every arch at its published widths, depth cut to one pattern unit
    (plus the dense-first layers).  The LM path reaches none of the
    port's CUDA kernels: their launch counts must not move."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.kernels import _lib

    before = dict(_lib.launch_counts)
    torch.cuda.reset_peak_memory_stats()
    full = lm_model_run(torch, get_config(LM_FULL_ARCH), device, seed,
                        LM_GEN, timing=True)
    full["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    archs = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        cut = lm_cut(cfg)
        torch.cuda.reset_peak_memory_stats()
        held = LM_HELD_ON.get(arch)
        r = lm_model_run(torch, cut, device, seed, LM_CUT_GEN,
                         hold=held is None)
        r["reduced"] = {"num_layers": [cfg.num_layers, cut.num_layers]}
        if held:
            pair = dataclasses.replace(cut, block_pattern=held,
                                       num_layers=len(held))
            r["held_on"] = lm_model_run(torch, pair, device, seed,
                                        LM_CUT_GEN)
            r["held_on"]["block_pattern"] = list(held)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        archs.append(r)
        torch.cuda.empty_cache()
    check(_lib.launch_counts == before,
          "the LM path launched a sparse kernel")
    return {"full": full, "archs": archs,
            "requests": LM_BATCH, "prompt_tokens": LM_PROMPT,
            "new_tokens": [LM_GEN, LM_CUT_GEN], "tolerance": LM_TOL}


# --------------------------------------------------------------------------
# lm_train: the LM training path
# --------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 (data sheet)
#: ``lm_train``'s full-size run: TRAIN_BATCH x TRAIN_SEQ tokens a step, one
#: plain warm-up step, one step under the ATen op counter, then
#: TRAIN_TIMED steps under CUDA events.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED = 4, 512, 4
#: The cut archs' steps (at grad_accum 2), and the card-against-CPU and
#: restart runs' batch (qwen3-4b cut to one layer at full width).
TRAIN_CUT_STEPS, TRAIN_CUT_ACCUM = 2, 2
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ = 2, 64
#: Bytes a parameter: an AdamW step holds bf16 weights and gradients and
#: f32 m and v (12); grad_accum > 1 adds the f32 accumulators (4).
STEP_BYTES, ACCUM_BYTES = 12, 4
#: Bytes of optimizer traffic a parameter: read p, g, m, v, write p, m, v,
#: and the gradient norm's read of g, all once.
OPT_BYTES = 2 + 2 + 4 + 4 + 2 + 4 + 4 + 2
#: The step-0 loss the train step returns against a separate ``loss_fn``
#: on the same weights (the same forward ops, with and without autograd).
TRAIN_LOSS_SELF_TOL = 1e-3
#: Card against CPU, one step from the same weights and batch: the CPU
#: tests' tolerances (tests/test_torch_train_loop.py: the loss 5e-3
#: absolute, gnorm 1e-2 relative, a parameter within 2 lr a step plus one
#: bf16 ulp of its value, and at most 1% of the elements more than an ulp
#: apart; tests/test_torch_train_grads.py: a gradient leaf within 0.06 of
#: its max |value|, so m = 0.1 g after one step within 0.06 of its max and
#: v, which goes as g**2, within 0.12).
CARD_CPU_TOL = {"loss": 5e-3, "gnorm": 1e-2, "m": 0.06, "v": 0.12,
                "param_lr": 2.0, "max_moved": 0.01}
RESTART_RTOL = 1e-5              # tests/test_fault_tolerance.py's


def one_device_mesh(device):
    from repro_torch.launch.mesh import Mesh
    return Mesh(("data", "model"), (1, 1), (device,))


def train_bound_ms(cfg, batch: int, seq: int) -> dict:
    """The least time of one AdamW step on the card: 6 N T FLOP of the
    products (N: every parameter but the embedding table, a lookup; T
    tokens) plus the dense S x S attention products forward and backward
    (3 x layers x 4 B H S^2 hd), over the bf16 peak; then the optimizer's
    bytes (OPT_BYTES a parameter) over the memory rate.  The recompute of
    remat is not useful work and stays out."""
    from repro_torch.models import params as pp
    n_all = pp.count_params_config(cfg)
    n = n_all - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    attn = cfg.num_layers * 3 * 4 * batch * cfg.num_heads * seq * seq * \
        cfg.head_dim
    flops = 6 * n * batch * seq + attn
    opt_bytes = OPT_BYTES * n_all
    compute_ms = flops / BF16_FLOPS_PER_S * 1e3
    memory_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "optimizer_bytes": opt_bytes,
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "bound_ms": compute_ms + memory_ms}


def train_stream(cfg, batch, seq, seed):
    from repro_torch.data.synthetic import DataConfig, TokenStream
    return TokenStream(cfg, DataConfig(seed=seed, batch=batch, seq_len=seq))


def train_steps(torch, cfg, params, opt, stream, steps, device, *,
                grad_accum=1, first=0, total=None, timed=False, count=False,
                mesh=None, fsdp=False):
    """``steps`` steps of ``make_train_step`` (remat on) from step
    ``first`` of a ``total``-step schedule (``first + steps`` when None),
    each checked: finite loss and gnorm, ``lr`` equal to ``schedule`` of
    the step on its device.  Returns (params, opt, per-step records);
    ``timed``: each step's ms under CUDA events and the host's ms to
    enqueue it; ``count``: each step's ATen ops.  ``mesh``: the mesh to
    train on (the one-device mesh when None)."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1,
                                total_steps=total or first + steps)
    step_fn, _, _ = loop.make_train_step(
        cfg, opt_cfg, mesh or one_device_mesh(device),
        loop.RunConfig(fsdp=fsdp, remat=True, grad_accum=grad_accum))
    batches = [loop.to_device(stream.batch_at(first + i), device)
               for i in range(steps)]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    out = []
    events[0].record()
    ops, host_ms = [], []
    for i, b in enumerate(batches):
        gen = loop.step_generator(device, first + i)
        t0 = time.perf_counter()
        if count:
            res = {}
            ops.append(aten_ops(torch, lambda: res.update(
                r=step_fn(params, opt, b, gen))))
            params, opt, m = res["r"]
        else:
            params, opt, m = step_fn(params, opt, b, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        events[i + 1].record()
        out.append(m)
    torch.cuda.synchronize()
    records = []
    for i, m in enumerate(out):
        want_lr = adamw.schedule(opt_cfg, torch.tensor(
            first + i + 1, dtype=torch.int32, device=device))
        check(bool(torch.isfinite(m["loss"])) and
              bool(torch.isfinite(m["gnorm"])),
              f"{cfg.name}: step {first + i} loss or gnorm not finite")
        check(torch.equal(m["lr"], want_lr),
              f"{cfg.name}: step {first + i} lr off the schedule")
        r = {k: float(v) for k, v in m.items()}
        if timed:
            r["ms"] = events[i].elapsed_time(events[i + 1])
            r["host_ms"] = host_ms[i]
        if count:
            r["aten_ops"] = ops[i]
        records.append(r)
    return params, opt, records


def lm_train_steps_like(torch, cfg, params, opt, stream, device, timed,
                        **kw) -> tuple:
    """``lm_train_full``'s step sequence: a warm-up step, a step under the
    ATen op counter, ``timed`` steps under CUDA events.  Returns (params,
    opt, {"warm", "count", "timed": their records, "warmup_s",
    "timed_wall_s": host seconds})."""
    total = 2 + timed
    t0 = time.perf_counter()
    params, opt, warm = train_steps(torch, cfg, params, opt, stream, 1,
                                    device, total=total, **kw)
    warmup_s = time.perf_counter() - t0
    params, opt, cnt = train_steps(torch, cfg, params, opt, stream, 1,
                                   device, first=1, total=total, count=True,
                                   **kw)
    t0 = time.perf_counter()
    params, opt, steps = train_steps(torch, cfg, params, opt, stream, timed,
                                     device, first=2, total=total,
                                     timed=True, **kw)
    return params, opt, {"warm": warm, "count": cnt, "timed": steps,
                         "warmup_s": warmup_s,
                         "timed_wall_s": time.perf_counter() - t0}


def lm_train_full(torch, cfg, device, seed, batch, seq, timed) -> dict:
    """``cfg`` at its published size: init from a seeded generator on the
    card, AdamW state on top, a warm-up step, a step under the ATen op
    counter, ``timed`` steps under CUDA events; the checks of
    ``train_steps``, the step-0 loss against a separate ``loss_fn``, and
    the loss on step 0's batch lower after the steps."""
    from repro_torch.models import model as mm
    from repro_torch.models import params as pp
    from repro_torch.optim import adamw
    from repro_torch.train import loop

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = pp.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    opt = adamw.init_state(params)
    torch.cuda.synchronize()
    out = dict(arch=cfg.name, layers=cfg.num_layers,
               params=pp.count_params_config(cfg),
               init_s=time.perf_counter() - t0,
               static_gb=torch.cuda.memory_allocated() / 1e9,
               batch=batch, seq=seq, tokens_per_step=batch * seq)
    stream = train_stream(cfg, batch, seq, seed)
    b0 = loop.to_device(stream.batch_at(0), device)
    with torch.no_grad():
        loss0 = float(mm.loss_fn(params, cfg, b0)[0])
    params, opt, run = lm_train_steps_like(torch, cfg, params, opt, stream,
                                           device, timed)
    warm, cnt, steps = run["warm"], run["count"], run["timed"]
    out["warmup_s"] = run["warmup_s"]
    out["loss_before"] = loss0
    out["step0_loss_vs_loss_fn"] = abs(warm[0]["loss"] - loss0)
    check(out["step0_loss_vs_loss_fn"] <= TRAIN_LOSS_SELF_TOL,
          f"{cfg.name}: the step's loss {warm[0]['loss']} is not loss_fn's "
          f"{loss0}")
    out["aten_ops_per_step"] = cnt[0]["aten_ops"]
    wall = run["timed_wall_s"]
    ms = [r["ms"] for r in steps]
    out["ms_per_step"] = float(np.median(ms))
    out["ms_all"] = ms
    # the host's own time to issue a step (it returns before the card is
    # done unless the launch queue fills)
    out["host_issue_ms"] = [r["host_ms"] for r in steps]
    out["host_wall_ms_per_step"] = wall * 1e3 / timed
    out["tokens_per_s"] = batch * seq * 1000.0 / out["ms_per_step"]
    out.update(train_bound_ms(cfg, batch, seq))
    out["bound_share"] = out["bound_ms"] / out["ms_per_step"]
    out["steps"] = [{k: r[k] for k in ("loss", "gnorm", "lr")}
                    for r in warm + cnt + steps]
    with torch.no_grad():
        out["loss_after"] = float(mm.loss_fn(params, cfg, b0)[0])
    check(out["loss_after"] < loss0,
          f"{cfg.name}: loss on step 0's batch {loss0} -> "
          f"{out['loss_after']}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(device).total_memory
    out["card_gb"] = total / 1e9
    check(torch.cuda.max_memory_allocated() < total,
          f"{cfg.name}: peak memory over the card's")
    return out


def lm_train_cut(torch, cfg, device, seed, batch, seq) -> dict:
    """One pattern unit at full width, bf16 weights: TRAIN_CUT_STEPS steps
    at grad_accum TRAIN_CUT_ACCUM, each checked by ``train_steps``."""
    from repro_torch.models import params as pp
    from repro_torch.optim import adamw
    torch.cuda.reset_peak_memory_stats()
    params = pp.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device=device)
    opt = adamw.init_state(params)
    _, _, steps = train_steps(torch, cfg, params, opt,
                              train_stream(cfg, batch, seq, seed),
                              TRAIN_CUT_STEPS, device,
                              grad_accum=TRAIN_CUT_ACCUM, timed=True)
    return dict(arch=cfg.name, layers=cfg.num_layers,
                params=pp.count_params_config(cfg),
                steps=[{k: r[k] for k in ("loss", "gnorm", "lr", "ms")}
                       for r in steps],
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def rel_to_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def lm_train_card_vs_cpu(torch, cfg, device, seed, batch, seq) -> dict:
    """One step on the card and one on the CPU, the port's own code on
    both, from the same weights (drawn on the CPU) and batch: the loss,
    gnorm, m, v and the parameters within CARD_CPU_TOL."""
    from repro_torch.models import params as pp
    from repro_torch.optim import adamw
    cpu = torch.device("cpu")
    stream = train_stream(cfg, batch, seq, seed)
    host = pp.init_params(cfg, torch.Generator().manual_seed(seed),
                          device=cpu)
    card = pp.tree_map(lambda t: t.to(device, copy=True), host)
    runs = {}
    for name, dev, params in (("card", device, card), ("cpu", cpu, host)):
        t0 = time.perf_counter()
        params, opt, (r,) = train_steps(
            torch, cfg, params, adamw.init_state(params), stream, 1, dev)
        runs[name] = (params, opt, r, time.perf_counter() - t0)
    (pc, oc, rc, sc), (ph, oh, rh, sh) = runs["card"], runs["cpu"]
    lr = rh["lr"]
    out = {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "seq": seq, "card_s": sc, "cpu_s": sh,
           "loss": [rc["loss"], rh["loss"]],
           "gnorm": [rc["gnorm"], rh["gnorm"]], "tolerance": CARD_CPU_TOL}
    check(abs(rc["loss"] - rh["loss"]) <= CARD_CPU_TOL["loss"],
          f"card against CPU: loss {rc['loss']} / {rh['loss']}")
    check(abs(rc["gnorm"] / rh["gnorm"] - 1) <= CARD_CPU_TOL["gnorm"],
          f"card against CPU: gnorm {rc['gnorm']} / {rh['gnorm']}")
    worst = {"m": 0.0, "v": 0.0, "param_lr": 0.0}
    for key, a_tree, b_tree in (("m", oc.m, oh.m), ("v", oc.v, oh.v)):
        for a, b in zip(pp.tree_leaves(a_tree), pp.tree_leaves(b_tree)):
            worst[key] = max(worst[key], rel_to_max(a.cpu(), b))
    over = 0.0
    moved = total = 0
    for a, b in zip(pp.tree_leaves(pc), pp.tree_leaves(ph)):
        diff = (a.cpu().float() - b.float()).abs()
        ulp = bf16_ulp(torch, b)
        worst["param_lr"] = max(worst["param_lr"], float(diff.max()) / lr)
        over = max(over, float((diff - CARD_CPU_TOL["param_lr"] * lr
                                - ulp).max()))
        moved += int((diff > ulp).sum())
        total += diff.numel()
    out["worst"] = worst
    out["param_over_bound"] = over
    out["moved_share"] = moved / total
    for key in ("m", "v"):
        check(worst[key] <= CARD_CPU_TOL[key],
              f"card against CPU: {key} {worst[key]}")
    check(over <= 0, f"card against CPU: a parameter {over} past 2 lr and "
          f"an ulp")
    check(moved <= CARD_CPU_TOL["max_moved"] * total,
          f"card against CPU: {moved} of {total} parameters more than an "
          f"ulp apart")
    return out


def bf16_ulp(torch, t):
    """One bf16 ulp of each value: 2**-7 of the power of two at or below
    |t| (the least normal's below it)."""
    e = torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def lm_train_restart(torch, cfg, device, seed, batch, seq, ckpt_dir) -> dict:
    """4 steps through ``train_loop`` with a checkpoint after step 2, then
    ``elastic.resume`` onto a one-device mesh and steps 2-3 again: the
    losses equal at RESTART_RTOL."""
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import elastic, loop
    mesh = one_device_mesh(device)
    run = loop.RunConfig(fsdp=False, remat=True)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    stream = train_stream(cfg, batch, seq, seed)
    first, again = {}, {}
    t0 = time.perf_counter()
    params, opt, _ = loop.train_loop(
        cfg, opt_cfg, mesh, stream, 2, run, checkpoint_dir=ckpt_dir,
        checkpoint_every=2, on_metrics=lambda s, m: first.update({s: m}))
    loop.train_loop(cfg, opt_cfg, mesh, stream, 4, run, start_step=2,
                    params=params, opt_state=opt,
                    on_metrics=lambda s, m: first.update({s: m}))
    del params, opt
    ckpt.wait_for_writes()
    t1 = time.perf_counter()
    params, opt, step = elastic.resume(cfg, opt_cfg, ckpt_dir, mesh, run)
    restore_s = time.perf_counter() - t1
    check(step == 2, f"restart: resumed at step {step}")
    loop.train_loop(cfg, opt_cfg, mesh, stream, 4, run, start_step=step,
                    params=params, opt_state=opt,
                    on_metrics=lambda s, m: again.update({s: m}))
    out = {"losses": [first[s]["loss"] for s in range(4)],
           "resumed_losses": [again[s]["loss"] for s in (2, 3)],
           "restore_s": restore_s, "total_s": time.perf_counter() - t0,
           "rtol": RESTART_RTOL}
    for s in (2, 3):
        check(abs(again[s]["loss"] - first[s]["loss"])
              <= RESTART_RTOL * abs(first[s]["loss"]),
              f"restart: step {s} loss {again[s]['loss']} against "
              f"{first[s]['loss']}")
    return out


def free_card(torch) -> float:
    """Release what earlier phases left cached; the GB still allocated."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def lm_train_phase(torch, device, seed, ckpt_dir=None) -> dict:
    """The LM training path: ``LM_FULL_ARCH`` at its published size, then
    every arch at its published widths cut to one pattern unit (those
    whose AdamW state with accumulators fits on the card), then the
    card-against-CPU step and the restart on ``LM_FULL_ARCH`` cut to one
    layer.  The path reaches none of the port's CUDA kernels: their
    launch counts must not move."""
    from repro_torch.configs.registry import ARCH_IDS, get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import params as pp

    before = dict(_lib.launch_counts)
    out = {"held_gb_before": free_card(torch)}
    cfg = get_config(LM_FULL_ARCH)
    out["full"] = lm_train_full(torch, cfg, device, seed, TRAIN_BATCH,
                                TRAIN_SEQ, TRAIN_TIMED)
    free_card(torch)
    total = torch.cuda.get_device_properties(device).total_memory
    archs, skipped = [], []
    for arch in ARCH_IDS:
        cut = lm_cut(get_config(arch))
        n = pp.count_params_config(cut)
        need = (STEP_BYTES + ACCUM_BYTES) * n
        if need > total:
            skipped.append({"arch": arch, "params": n,
                            "static_gb": STEP_BYTES * n / 1e9,
                            "with_accumulators_gb": need / 1e9})
            continue
        r = lm_train_cut(torch, cut, device, seed, TRAIN_BATCH, TRAIN_SEQ)
        r["reduced"] = {"num_layers": [get_config(arch).num_layers,
                                       cut.num_layers]}
        archs.append(r)
        free_card(torch)
    out["archs"], out["skipped"] = archs, skipped
    one = dataclasses.replace(cfg, num_layers=1)
    out["card_vs_cpu"] = lm_train_card_vs_cpu(
        torch, one, device, seed, TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ)
    free_card(torch)
    with tempfile.TemporaryDirectory(dir=ckpt_dir) as d:
        out["restart"] = lm_train_restart(torch, one, device, seed,
                                          TRAIN_SMALL_BATCH,
                                          TRAIN_SMALL_SEQ, d)
    check(_lib.launch_counts == before,
          "the LM training path launched a sparse kernel")
    out["grad_accum_cut"] = TRAIN_CUT_ACCUM
    return out


def dryrun_grid() -> dict:
    """``launch/dryrun.py`` over the whole grid on both production meshes
    (its per-cell lines kept out of this script's output): the counts of
    ok, skip and fail, the host seconds, and the qwen3-4b train cell's
    bytes a device."""
    import io
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res = dryrun.main(["--multi-pod", "both"])
    except SystemExit:
        res = None
    check(res is not None, "the dry run failed a cell:\n" +
          "\n".join(ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("FAIL")))
    counts = {k: sum(r["status"] == k for r in res)
              for k in ("ok", "skip", "fail")}
    cell = {r["mesh"]: r for r in res if r["arch"] == LM_FULL_ARCH and
            r["shape"] == "train_4k"}
    return {"counts": counts, "host_s": time.perf_counter() - t0,
            "cells": len(res),
            "qwen3_4b_train_4k": {
                m: {k: r[k] for k in ("bytes_per_device", "fsdp",
                                      "collective_bytes_per_device",
                                      "t_compute_s", "t_memory_s",
                                      "t_collective_s", "bottleneck")}
                for m, r in cell.items()}}


def lm_train_sharded_phase(torch, device, seed, one) -> dict:
    """The sharded training path on the card: a world-size-1 NCCL process
    group (a ``FileStore`` in a temporary directory) and the port's host
    mesh over it, (1, 1); ``LM_FULL_ARCH`` at its published size with
    ``fsdp=True`` takes ``lm_train_full``'s steps (the same seed, batches
    and schedule) through the sharded step, every loss, gnorm and lr held
    to the one-device run's (``one``: ``lm_train``'s ``full`` record)
    within ``CARD_CPU_TOL``, and whether they are bitwise; ms a step, ATen
    ops a step and peak memory beside ``one``'s.  Then the dry run's
    whole grid.  No fallback: a failed group or collective fails the run.
    The path reaches none of the sparse kernels."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as pp
    from repro_torch.train import loop

    before = dict(_lib.launch_counts)
    out = {"held_gb_before": free_card(torch)}
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_host_mesh(device=device.type)
            check(mesh.distributed and mesh.shape == {"data": 1, "model": 1}
                  and dist.get_backend() == backend,
                  f"the host mesh over the {backend} world: {mesh.shape}")
            cfg = get_config(LM_FULL_ARCH)
            run = loop.RunConfig(fsdp=True, remat=True)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt = loop.init_sharded(
                cfg, mesh, run,
                torch.Generator(device=device).manual_seed(seed))
            torch.cuda.synchronize()
            out["init_s"] = time.perf_counter() - t0
            out["static_gb"] = torch.cuda.memory_allocated() / 1e9
            stream = train_stream(cfg, one["batch"], one["seq"], seed)
            params, opt, done = lm_train_steps_like(
                torch, cfg, params, opt, stream, device, TRAIN_TIMED,
                mesh=mesh, fsdp=True)
            del params, opt
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        finally:
            dist.destroy_process_group()
    want = one["steps"]
    out["steps"] = [{k: r[k] for k in ("loss", "gnorm", "lr")} for r in
                    done["warm"] + done["count"] + done["timed"]]
    out["bitwise"] = out["steps"] == want
    out["loss_off"] = max(abs(a["loss"] - b["loss"])
                          for a, b in zip(out["steps"], want))
    out["gnorm_off"] = max(abs(a["gnorm"] / b["gnorm"] - 1)
                           for a, b in zip(out["steps"], want))
    check(len(out["steps"]) == len(want) and
          out["loss_off"] <= CARD_CPU_TOL["loss"] and
          out["gnorm_off"] <= CARD_CPU_TOL["gnorm"] and
          all(a["lr"] == b["lr"] for a, b in zip(out["steps"], want)),
          f"sharded steps {out['steps']} against one device's {want}")
    ms = [r["ms"] for r in done["timed"]]
    out.update(arch=cfg.name, mesh=mesh.shape, fsdp=True,
               params=pp.count_params_config(cfg),
               ms_per_step=float(np.median(ms)), ms_all=ms,
               aten_ops_per_step=done["count"][0]["aten_ops"],
               one_device={k: one[k] for k in (
                   "ms_per_step", "aten_ops_per_step", "peak_gb")})
    out["dryrun"] = dryrun_grid()
    check(_lib.launch_counts == before,
          "the sharded training path launched a sparse kernel")
    return out


EXAMPLES_DIR = ROOT / "examples_torch"
#: ``train_lm``'s steps here: its default, 200 (four checkpoints).
EXAMPLE_TRAIN_STEPS = 200


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(mod, argv):
    """``mod.main(argv)`` with the example's printout sent to stderr;
    returns (its result, its wall seconds)."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = mod.main(argv)
    return result, time.perf_counter() - t0


def route_flips(torch, cfg, params, x, ids_a, ids_b) -> int:
    """(token, k) picks on which two runs' routes part, each checked to
    be a near-tie: the gap between the k-th and (k+1)-th router logits
    (float64) within twice the dot product's rounding bound in float32,
    2 d u sum_j |x_j r_je| (u = 2^-24), of the experts involved."""
    d = x.shape[-1]
    xs = x.reshape(-1, d).double().cpu()
    r = params["router"].double().cpu()
    logits = xs @ r
    bound = 2 * d * 2.0 ** -24 * (xs.abs() @ r.abs())          # (T, E)
    a, b = ids_a.cpu(), ids_b.cpu()
    flips = 0
    for t in torch.nonzero((a.sort(-1).values != b.sort(-1).values)
                           .any(-1)).flatten().tolist():
        srt, order = logits[t].sort(descending=True)
        k = cfg.top_k
        gap = float(srt[k - 1] - srt[k])
        tol = float(bound[t, order[k - 1]] + bound[t, order[k]])
        check(gap <= tol, f"moe_valiant: token {t}'s route parts from the "
              f"CPU's at a gap {gap} over the rounding bound {tol}")
        flips += int((a[t].sort().values != b[t].sort().values).sum())
    return flips


def examples_phase(torch, device, work_dir) -> dict:
    """The six examples of ``examples_torch/`` through their ``main``
    (``run`` where a check needs the CPU's twin), on ``device``:

    * ``quickstart``, ``reorder_study`` (host only): their tables, finite;
    * ``autotune_serve``: every tenant's scaled error <= E2E_TOL, and the
      SpMV kernels its graphed executors launched (warm-ups and captures;
      out of the kernels line, as the serving phase's);
    * ``serve_lm``: the prompts back unchanged, each generated token's
      logit in a forward pass over the served tokens within LM_TOL of its
      position's maximum;
    * ``moe_valiant``: the load sums to T top_k and equals the CPU's on
      the same inputs but at near-tied routes (``route_flips``), the
      drops too where no route parts;
    * ``train_lm`` at its default width and depth: every loss and gnorm
      finite, the mean of the last 10 losses below the first 10's, four
      checkpoints written, ms a step."""
    from repro_torch.kernels import _lib
    from repro_torch.models import model as mm
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import checkpoint

    dev = str(device)
    out = {"held_gb_before": free_card(torch)}

    qs, s = run_example(load_example("quickstart"), [])
    check(len(qs["rows"]) == 16 and all(
        np.isfinite(r["bandwidth_mbs"]) and r["bandwidth_mbs"] > 0
        for r in qs["rows"]), "quickstart: its table")
    out["quickstart"] = {"phase_s": s, "table": [
        [r["reordering"], r["layout"], r["distribution"],
         r["bandwidth_mbs"], r["migrations"], r["hotspot_share"]]
        for r in qs["rows"]]}

    rs, s = run_example(load_example("reorder_study"), [])
    check(len(rs["rows"]) == 4 and all(
        np.isfinite(v) and v > 0 for r in rs["rows"]
        for v in (r["emu_mbs"], r["cpu_mbs"])), "reorder_study: its table")
    out["reorder_study"] = {"phase_s": s, "table": [
        [r["reordering"], r["emu_mbs"], r["emu_gain"], r["cpu_mbs"],
         r["cpu_gain"]] for r in rs["rows"]]}

    before = dict(_lib.launch_counts)
    at, s = run_example(load_example("autotune_serve"), ["--device", dev])
    torch.cuda.synchronize()
    launched = {k: _lib.launch_counts[k] - before[k] for k in before
                if _lib.launch_counts[k] != before[k]}
    errs = {k: t["scaled_error"] for k, t in at["tenants"].items()}
    check(all(e <= E2E_TOL for e in errs.values()),
          f"autotune_serve: scaled errors {errs}")
    check(any(launched.get(k, 0) for k in SERVING_KERNELS),
          f"autotune_serve launched none of the SpMV kernels: {launched}")
    out["autotune_serve"] = {
        "phase_s": s, "scaled_error": errs, "launched": launched,
        "plans": {k: [t["plan"], t["shard_kernels"]]
                  for k, t in at["tenants"].items()},
        "gate": {k: g["pays"] for k, g in at["gate"].items()}}
    del at
    free_card(torch)

    before = dict(_lib.launch_counts)
    sl, s = run_example(load_example("serve_lm"), ["--device", dev])
    P = sl["prompts"].shape[1]
    toks = sl["tokens"]
    check(np.array_equal(toks[:, :P], sl["prompts"]),
          "serve_lm: the prompts came back changed")
    ids = torch.from_numpy(toks.astype(np.int64)).to(device)
    with torch.no_grad():
        full, _ = mm.forward(sl["params"], sl["cfg"], {"tokens": ids[:, :-1]})
    full = full[:, P - 1:].float()                      # (B, gen, V)
    mx = full.amax(dim=-1)
    got = full.gather(-1, ids[:, P:, None])[..., 0]
    over = float(((mx - got) - LM_TOL * (1 + mx.abs())).max())
    check(bool(torch.isfinite(full).all()) and over <= 0,
          f"serve_lm: a generated token's logit lies {over} past "
          f"{LM_TOL} of its position's maximum")
    out["serve_lm"] = {"phase_s": s, "tokens": toks.tolist(),
                       "max_gap_to_max_logit": float((mx - got).max()),
                       "argmax_tokens": int((got == mx).sum()),
                       "generated": int(got.numel())}
    del sl, full
    check(_lib.launch_counts == before, "serve_lm launched a sparse kernel")

    mod = load_example("moe_valiant")
    mv, s = run_example(mod, ["--device", dev])
    cfg, params, x, _ = mod.inputs()
    with contextlib.redirect_stdout(sys.stderr):
        cpu = mod.run(*mod.inputs(), torch.device("cpu"))
    T = x.shape[0] * x.shape[1]
    check(float(mv["load"].sum()) == T * cfg.top_k,
          f"moe_valiant: the load sums to {mv['load'].sum()}, not "
          f"{T * cfg.top_k}")
    flips = route_flips(torch, cfg, params, x, mv["ids"], cpu["ids"])
    load_off = int(np.abs(mv["load"] - cpu["load"]).sum())
    check(load_off <= 2 * flips and (flips or mv["drop"] == cpu["drop"]),
          f"moe_valiant: load {mv['load']} against the CPU's {cpu['load']}"
          f" with {flips} near-tied picks; drops {mv['drop']} against "
          f"{cpu['drop']}")
    out["moe_valiant"] = {"phase_s": s, "load": mv["load"].tolist(),
                          "cpu_load": cpu["load"].tolist(),
                          "route_flips": flips, "drop": list(mv["drop"])}
    del mv, cpu

    free_card(torch)
    before = dict(_lib.launch_counts)
    ckpt = os.path.join(work_dir, "train_lm_ckpt")
    torch.cuda.reset_peak_memory_stats()
    tl, s = run_example(load_example("train_lm"), [
        "--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt", ckpt, "--device", dev])
    loss = [m["loss"] for m in tl["metrics"]]
    gnorm = [m["gnorm"] for m in tl["metrics"]]
    check(len(loss) == EXAMPLE_TRAIN_STEPS and
          bool(np.isfinite(loss).all() and np.isfinite(gnorm).all()),
          "train_lm: a loss or gnorm is not finite")
    check(np.mean(loss[-10:]) < np.mean(loss[:10]),
          f"train_lm: the loss did not fall ({np.mean(loss[:10])} -> "
          f"{np.mean(loss[-10:])})")
    steps = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    check(len(steps) == EXAMPLE_TRAIN_STEPS // 50 and
          checkpoint.latest_step(ckpt) == EXAMPLE_TRAIN_STEPS,
          f"train_lm: checkpoints {steps}")
    check(_lib.launch_counts == before, "train_lm launched a sparse kernel")
    ms = [1e3 * t for t in tl["step_s"]]
    out["train_lm"] = {
        "phase_s": s, "steps": EXAMPLE_TRAIN_STEPS,
        "params": int(sum(t.numel() for t in tree_leaves(tl["params"]))),
        "loss_first": loss[0], "loss_last": loss[-1],
        "loss_mean_first10": float(np.mean(loss[:10])),
        "loss_mean_last10": float(np.mean(loss[-10:])),
        "gnorm_max": float(np.max(gnorm)), "checkpoints": steps,
        "ms_per_step": float(np.median(ms)), "ms_first_step": ms[0],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tl
    free_card(torch)
    return out


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

    with tempfile.TemporaryDirectory() as artifact_dir:
        return run_phases(torch, device, args.seed, artifact_dir)


def run_phases(torch, device, seed, artifact_dir) -> int:
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import _lib

    t0 = time.perf_counter()
    cop = mats.make_matrix("cop20k_A")
    cop_s = time.perf_counter() - t0
    # its own generator, so the later phases' inputs stay as they were
    choice, planner = planner_phase(torch, cop, device, seed + 1,
                                    os.path.join(artifact_dir, "cop20k_A"))
    planner["matrix_s"] = cop_s
    print(json.dumps({"planner": planner}))

    rng = np.random.default_rng(seed)
    results, totals, matrices = {}, {name: 0 for name in _lib.KERNELS}, {}
    tenant_plans = {}
    for label, build, plans in phases(cop, choice.plan):
        # the serving phase's tenants: cop20k_A warm from the planner's
        # bundle, the others under their phase's (first) plan
        tenant_plans[label] = None if label == "cop20k_A" else plans[0][1]
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
    # serving through the router; its launches (warm-ups and captures) are
    # its own and stay out of the kernels line
    t0 = time.perf_counter()
    serving = serving_phase(torch, matrices, tenant_plans, artifact_dir,
                            device, seed + 2)
    serving["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"serving": serving}))
    t0 = time.perf_counter()
    lm = lm_serve_phase(torch, device, seed + 3)
    lm["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"lm_serve": lm}))
    del lm
    t0 = time.perf_counter()
    train = lm_train_phase(torch, device, seed + 4, artifact_dir)
    train["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"lm_train": train}))
    t0 = time.perf_counter()
    sharded = lm_train_sharded_phase(torch, device, seed + 4, train["full"])
    sharded["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"lm_train_sharded": sharded}))
    t0 = time.perf_counter()
    examples = examples_phase(torch, device, artifact_dir)
    examples["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"examples": examples}))
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
