#!/usr/bin/env python3
"""Time kernels at each value of their tuning constant on one GPU.

    python3 tools/kernel_variants.py                 # every sweep
    python3 tools/kernel_variants.py contrib tile    # only these sweeps

Compiles a kernel source once for each value of one ``constexpr`` into its
own library under ``build/kernel_variants/``, then times each library's
launches with CUDA events (replayed as CUDA graphs), two turns in a row:

* ``contrib``: ``spmv_tile.cu``'s ``PREFETCH`` (tiles whose data and lane
  positions ``tile_contrib`` loads ahead of a tile's FMAs): 1, 2, 4, on
  the blocked_band program of ``chip_smoke.py``: its two ``tile_contrib``
  launches (local and remote pass) in one graph;
* ``tile``: ``spmv_tile.cu``'s ``STEPS`` (warp steps whose masks and first
  cells the tile walk loads at once): 1, 2, 4, 8, on the api/tile case of
  ``chip_smoke.py`` (``tile_from_csr(blocked_band(131072, 32·131072))``);
* ``general``: the general walks' constants in ``spmv_tile.cu``:
  ``GENERAL_GROUP`` (the most rows a warp of the masked walk owns) 8, 4, 2
  by ``GENERAL_STEPS`` (items whose masks and first cells it loads at
  once) 1, 2, on the api/tile16x64 and api/tile32x32 cases;
  ``GENERAL_PREFETCH`` (items the null-mask and ``tile_contrib`` walks
  load ahead of the adds): 1, 2, 4, and ``GENERAL_ROWS`` (the most rows a
  warp of those walks holds): 2, 4, 8, 16, on api/bell16x16 (the
  null-mask walk on the (16, 16) Block-ELL slab of
  ``blocked_band(16384, 32·16384)``) and api/tile_flat16x128
  (``tile_contrib`` on that matrix's (16, 128) flat tile operands);
* ``ell``: ``spmv_ell.cu``'s ``G`` (lanes a row): 4, 8, 16, 32, on one
  SpMV's ``ell_spmv`` launches (both passes, each family) of the
  cop20k_A/ell and blocked_band programs of ``chip_smoke.py``, and on the
  per-format API's cop20k_A ELL slab (no length table);
* ``seg``: ``spmv_seg.cu``'s ``LONG_ROW`` (pieces a lane of the carry
  fix-up walks alone before the block's warps take the row): 2, 4, 8, 16,
  on one SpMV's ``seg_fixup`` launches of the cop20k_A/seg, blocked_band
  and powerlaw_tail programs and on the per-format API's api/split8 and
  api/split64 fix-ups; and its ``CHUNKS_PER_BLOCK`` (``seg_psum``'s
  warps, one chunk each, a block): 2, 4, 8, 16, on the same programs'
  ``seg_psum`` launches and on api/split8's and api/split64's
  ``split_psum`` (the same scan, on the flattened slab with one shared x),
  there also with every column index 0 (``cols=0``: the same loads and
  stores, but every x gather hits one sector, so the gap to the real
  case is what the scattered gathers cost);
* ``rows``: ``spmv_seg.cu``'s ``ROWS_AHEAD`` (steps whose x rows a
  batched scan gathers before it scans them): 1, 2, 4, by its
  ``SCAN_BLOCKS`` (blocks an SM the batched scans are built for): 1, 4,
  5, on both passes'
  ``seg_piece_sums`` and ``seg_psum`` launches of audikw_1's plan on a
  half-size stand-in (``banded(471500, 38.8M, 4715)``, 8 shards, halo;
  its remote x buffer at B = 8 is twice the L2), at B = 8 (16-byte row
  loads) and B = 3 (4-byte ones); each variant bitwise the library's.

Each for one vector and an (N, 8) block.  Every variant is first checked
against the kernel's plain version (rtol = atol = 1e-5 on |A|·|x|; the
fix-up exactly, against its plain version on CPU copies).
Prints the card's name and power limit, each build's register report,
and one JSON line per (case, value, turn).  Exits non-zero without CUDA.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-5


def build(source: str, const, values, symbol) -> dict:
    """value -> the C launcher ``symbol`` of ``source`` compiled with
    ``constexpr int <const> = value`` (a tuple of symbols: a tuple of
    launchers; a tuple of constants: each value a tuple of theirs)."""
    from repro_torch.kernels import _lib

    src = (_lib.CSRC / source).read_text()
    names = (const,) if isinstance(const, str) else const
    decls = [re.compile(rf"constexpr int {c} = \d+;") for c in names]
    for c, decl in zip(names, decls):
        if not decl.search(src):
            raise RuntimeError(f"{source} has no constexpr {c}")
    out = ROOT / "build" / "kernel_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in values:
        vs = (v,) if isinstance(const, str) else v
        text = src
        for c, decl, x in zip(names, decls, vs):
            text = decl.sub(f"constexpr int {c} = {x};", text)
        tag = "_".join(f"{c}{x}" for c, x in zip(names, vs))
        stem = out / f"{Path(source).stem}_{tag}"
        stem.with_suffix(".cu").write_text(text)
        so, cu = stem.with_suffix(".so"), stem.with_suffix(".cu")
        procs[v] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-I", str(_lib.CSRC),
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (so, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {const} = {v}:\n{text}")
        print(json.dumps({"source": source, label(const): v,
                          "ptxas": registers(text)}))
        lib = ctypes.CDLL(str(so))
        got = []
        for sym in (symbol,) if isinstance(symbol, str) else symbol:
            fn = getattr(lib, sym)
            fn.argtypes = _lib._SIGNATURES[sym]
            fn.restype = ctypes.c_int
            got.append(fn)
        fns[v] = got[0] if isinstance(symbol, str) else tuple(got)
    return fns


def label(const) -> str:
    return const if isinstance(const, str) else ",".join(const)


def registers(text: str) -> dict:
    """Each kernel's registers (and spill stores) from a ``ptxas -v`` report,
    by its mangled name."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name and int(m.group(1)):
            out[name + " spill"] = int(m.group(1))
    return out


def sweep(torch, case, const, fns, launch, check):
    """Check, then time, ``launch(fn)`` for every variant, two turns."""
    import chip_smoke as cs

    for v, fn in fns.items():
        launch(fn)
        check(f"{case} {label(const)}={v}")
    for turn in range(2):
        for v, fn in fns.items():
            ms = cs.graph_ms(torch, lambda fn=fn: launch(fn))
            print(json.dumps({"case": case, label(const): v,
                              "turn": turn, "ms": ms}))


def close(torch, got, want, scale, what):
    if not bool(((got - want).abs() <= TOL * (1.0 + scale)).all()):
        raise AssertionError(f"{what}: disagrees with the plain version")


def contrib_cases(torch, dev, rng, phases):
    from repro_torch.core import program as P
    from repro_torch.kernels import _lib, spmv_tile

    fns = build("spmv_tile.cu", "PREFETCH", (1, 2, 4), "rt_tile_spmv")
    (A, plans), = [(A, plans) for label, A, plans in phases
                   if label == "blocked_band"]
    for plan_label, plan in plans:
        prog = P.lower(A, plan)
        run = P.make_program_spmv_fn(prog, device=dev)
        T, sids = run.operands, run.families["tile"]
        for B in (1, 8):
            x = rng.standard_normal((A.ncols, B)).astype(np.float32)
            bufs = run.buffers(torch.from_numpy(prog.x_to_device(x)).to(dev))
            sets = [([T[pre + k] for k in ("tile_data", "tile_xcol",
                                           "tile_brow", "tile_ptr")],
                     xbuf, run.rb_used[pre],
                     torch.empty((run.shards[1] - run.shards[0], B,
                                  run.rows_out), device=dev))
                    for pre, xbuf in zip(("loc_", "rem_"), bufs)]

            def launch(fn, sets=sets):
                for (data, xcol, _, ptr), xbuf, rb, out in sets:
                    err = fn(data.data_ptr(), xcol.data_ptr(), ptr.data_ptr(),
                             xbuf.data_ptr(), _lib.x_stride(xbuf),
                             sids.data_ptr(), sids.numel(), data.shape[1],
                             ptr.shape[1] - 1, rb, 8, 128, xbuf.shape[2],
                             out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")

            def check(what, sets=sets):
                rows = sids.long()
                for a, xbuf, _, out in sets:
                    want = spmv_tile.tile_contrib_plain(
                        *a[:3], xbuf, sids, torch.empty_like(out))
                    scale = spmv_tile.tile_contrib_plain(
                        a[0].abs(), *a[1:3], xbuf.abs(), sids,
                        torch.empty_like(out))
                    close(torch, out[rows], want[rows], scale[rows], what)
            sweep(torch, f"{plan_label} B={B}", "PREFETCH", fns, launch,
                  check)


def tile_cases(torch, dev, rng):
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import ops, spmv_tile

    fns = build("spmv_tile.cu", "STEPS", (1, 2, 4, 8), "rt_tile_walk_spmv")
    M = 131072
    t = ops.tile_from_csr(mats.blocked_band(M, 32 * M, seed=0))
    data, tcols, tptr, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(
        dev) for a in (t.data, t.tile_cols, t.tile_ptr, t.mask))
    Mb, n = tptr.numel() - 1, t.shape[1]
    for B in (1, 8):
        xb = torch.from_numpy(np.ascontiguousarray(rng.standard_normal(
            (B, n)).astype(np.float32).T)).to(dev)               # (n, B)
        y = torch.empty((B, Mb * t.bm), device=dev)

        def launch(fn, x=xb, out=y):
            err = fn(data.data_ptr(), mask.data_ptr(), tcols.data_ptr(),
                     tptr.data_ptr(), x.data_ptr(), Mb, t.bm, t.bn, n,
                     x.shape[1], out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        def check(what, xb=xb, y=y):
            want = spmv_tile.tile_walk_spmv_plain(data, tcols, tptr, xb,
                                                  torch.empty_like(y))
            scale = spmv_tile.tile_walk_spmv_plain(
                data.abs(), tcols, tptr, xb.abs(), torch.empty_like(y))
            close(torch, y, want, scale, what)
        sweep(torch, f"api/tile B={B}", "STEPS", fns, launch, check)


def general_cases(torch, dev, rng):
    import warnings

    from repro_torch.core.sparse_matrix import csr_to_bcsr
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import ops, spmv_tile

    masked = ("GENERAL_GROUP", "GENERAL_STEPS")
    steps = build("spmv_tile.cu", masked, [(g, s) for g in (8, 4, 2)
                                           for s in (1, 2)],
                  "rt_tile_walk_spmv")
    both = ("rt_tile_walk_spmv", "rt_tile_spmv")
    cells = {const: build("spmv_tile.cu", const, values, both)
             for const, values in (
                 ("GENERAL_PREFETCH", (1, 2, 4)),
                 ("GENERAL_ROWS", (2, 4, 8, 16)))}

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def walk_sweep(case, const, fns, data, tcols, tptr, mask, n, pick):
        T, bm, bn = data.shape
        Mb = tptr.numel() - 1
        for B in (1, 8):
            xb = torch.from_numpy(np.ascontiguousarray(rng.standard_normal(
                (B, n)).astype(np.float32).T)).to(dev)           # (n, B)
            y = torch.empty((B, Mb * bm), device=dev)

            def launch(fn, x=xb, out=y):
                err = pick(fn)(data.data_ptr(),
                               None if mask is None else mask.data_ptr(),
                               tcols.data_ptr(), tptr.data_ptr(), x.data_ptr(),
                               Mb, bm, bn, n, x.shape[1], out.data_ptr(),
                               stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            def check(what, xb=xb, y=y):
                want = spmv_tile.tile_walk_spmv_plain(data, tcols, tptr, xb,
                                                      torch.empty_like(y))
                scale = spmv_tile.tile_walk_spmv_plain(
                    data.abs(), tcols, tptr, xb.abs(), torch.empty_like(y))
                close(torch, y, want, scale, what)
            sweep(torch, f"{case} B={B}", const, fns, launch, check)

    M = 131072
    band = mats.blocked_band(M, 32 * M, seed=0)
    for label, bm, bn in (("api/tile16x64", 16, 64),
                          ("api/tile32x32", 32, 32)):
        t = ops.tile_from_csr(band, bm=bm, bn=bn)
        data, tcols, tptr, mask = card(t.data, t.tile_cols, t.tile_ptr,
                                       t.mask)
        walk_sweep(label, masked, steps, data, tcols, tptr, mask,
                   band.ncols, lambda fn: fn)
        del t, data, tcols, tptr, mask
    small = mats.blocked_band(16384, 32 * 16384, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        blocks, bcols = ops.bell_from_bcsr(csr_to_bcsr(small, (16, 16)))
    Mb, K = bcols.shape
    data, tcols = card(blocks.reshape(Mb * K, 16, 16), bcols.reshape(-1))
    tptr = torch.arange(Mb + 1, dtype=torch.int32, device=dev) * K
    for const, fns in cells.items():
        walk_sweep("api/bell16x16", const, fns, data, tcols, tptr, None,
                   small.ncols, lambda fn: fn[0])
    # tile_contrib on the (16, 128) flat operands, as tile_flat_spmv
    # launches it: one shard, every block row walked
    t = ops.tile_from_csr(small, bm=16, bn=128)
    n, (T, bm, bn) = small.ncols, t.data.shape
    Rb = -(-small.nrows // bm)
    xcols = np.minimum(t.tile_cols[:, None].astype(np.int64) * bn
                       + np.arange(bn), n - 1).astype(np.int32)
    data, xcol, brow = card(t.data[None], xcols[None], t.tile_rows[None])
    ptr = ops._ranges(brow[0], Rb)[None]
    sids = torch.zeros(1, dtype=torch.int32, device=dev)
    for const, fns in cells.items():
        for B in (1, 8):
            x = torch.from_numpy(np.ascontiguousarray(rng.standard_normal(
                (1, B, n)).astype(np.float32).transpose(0, 2, 1))).to(dev)
            out = torch.empty((1, B, Rb * bm), device=dev)

            def launch(fn, x=x, out=out):
                err = fn[1](data.data_ptr(), xcol.data_ptr(), ptr.data_ptr(),
                            x.data_ptr(), 0, sids.data_ptr(), 1, T, Rb, Rb,
                            bm, bn, x.shape[2], out.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            def check(what, x=x, out=out):
                want = spmv_tile.tile_contrib_plain(data, xcol, brow, x, sids,
                                                    torch.empty_like(out))
                scale = spmv_tile.tile_contrib_plain(
                    data.abs(), xcol, brow, x.abs(), sids,
                    torch.empty_like(out))
                close(torch, out, want, scale, what)
            sweep(torch, f"api/tile_flat16x128 B={B}", const, fns, launch,
                  check)


def ell_cases(torch, dev, rng, phases):
    from repro_torch.core import program as P
    from repro_torch.core.sparse_matrix import csr_to_ell
    from repro_torch.kernels import _lib, spmv_ell

    fns = build("spmv_ell.cu", "G", (4, 8, 16, 32), "rt_ell_spmv")

    def operand_sets(run, pre, xbuf):
        T = run.operands
        for fam in ("ell", "hyb"):
            if fam in run.families:
                yield [T[pre + k] for k in (
                    "ell_data", "ell_cols", "ovf_rows", "ovf_cols",
                    "ovf_vals", "ovf_ptr")], T[pre + "ell_len"], xbuf, \
                    run.families[fam]

    def time_sets(case, sets):
        outs = [torch.empty((a[0].shape[0], x.shape[2], a[0].shape[1]),
                            device=dev) for a, _, x, _ in sets]

        def launch(fn, sets=sets, outs=outs):
            for (a, ell_len, x, sids), out in zip(sets, outs):
                data, cols, _, ovf_cols, ovf_vals, ovf_ptr = a
                err = fn(data.data_ptr(), cols.data_ptr(),
                         None if ell_len is None else ell_len.data_ptr(),
                         ovf_ptr.data_ptr(), ovf_cols.data_ptr(),
                         ovf_vals.data_ptr(), x.data_ptr(), _lib.x_stride(x),
                         sids.data_ptr(), sids.numel(), data.shape[1],
                         data.shape[2], ovf_vals.shape[1], x.shape[2],
                         out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

        def check(what):
            for (a, _, x, sids), out in zip(sets, outs):
                rows = sids.long()
                want = spmv_ell.ell_spmv_plain(*a, x, sids,
                                               torch.empty_like(out))
                absa = [a[0].abs()] + a[1:4] + [a[4].abs(), a[5]]
                scale = spmv_ell.ell_spmv_plain(*absa, x.abs(), sids,
                                                torch.empty_like(out))
                close(torch, out[rows], want[rows], scale[rows], what)
        sweep(torch, case, "G", fns, launch, check)

    cop = None
    for label, A, plans in phases:
        if label not in ("cop20k_A", "blocked_band"):
            continue
        cop = A if label == "cop20k_A" else cop
        for plan_label, plan in plans:
            if plan_label == "cop20k_A/seg":
                continue
            prog = P.lower(A, plan)
            run = P.make_program_spmv_fn(prog, device=dev)
            for B in (1, 8):
                x = rng.standard_normal((A.ncols, B)).astype(np.float32)
                xb, xg = run.buffers(torch.from_numpy(
                    prog.x_to_device(x)).to(dev))
                sets = [s for pre, buf in (("loc_", xb), ("rem_", xg))
                        for s in operand_sets(run, pre, buf)]
                time_sets(f"{plan_label} B={B}", sets)
    ell = csr_to_ell(cop)
    data, cols = (torch.from_numpy(a).to(dev) for a in (ell.data, ell.cols))
    z = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    ptr = torch.zeros((1, data.shape[0] + 1), dtype=torch.int32, device=dev)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    for B in (1, 8):
        x = torch.from_numpy(np.ascontiguousarray(rng.standard_normal(
            (1, B, cop.ncols)).astype(np.float32).transpose(0, 2, 1))).to(dev)
        time_sets(f"api/ell B={B}",
                  [([data[None], cols[None], z, z, z.float(), ptr], None, x,
                    one)])


def seg_cases(torch, dev, rng, phases):
    from repro_torch.core import program as P
    from repro_torch.kernels import _lib, ops, spmv_seg, spmv_split

    fixups = build("spmv_seg.cu", "LONG_ROW", (2, 4, 8, 16), "rt_seg_fixup")
    scans = build("spmv_seg.cu", "CHUNKS_PER_BLOCK", (2, 4, 8, 16),
                  "rt_seg_psum")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fixup_sweep(case, sets):
        """sets: [(psum, pieces, piece_ptr, sids, out_ids, NS, out)]."""
        def launch(fn):
            for psum, pcs, ptr, sids, ids, ns, out in sets:
                n, B, C, L = psum.shape
                err = fn(psum.data_ptr(), pcs.data_ptr(), ptr.data_ptr(),
                         sids.data_ptr(), ids.data_ptr(), n, C, L,
                         pcs.shape[1], ptr.shape[1] - 1, ns, B,
                         out.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

        def check(what):
            for psum, pcs, ptr, sids, ids, ns, out in sets:
                o = ids.long().cpu()
                want = spmv_seg.seg_fixup_plain(
                    *(t.cpu() for t in (psum, pcs, ptr, sids, ids)),
                    torch.empty(out.shape))
                if not torch.equal(out.cpu()[o], want[o]):
                    raise AssertionError(f"{what}: differs from the plain "
                                         f"version")
        sweep(torch, case, "LONG_ROW", fixups, launch, check)

    def scan_sweep(case, sets):
        """sets: [(vals, cols, x, sids, out)]."""
        def launch(fn):
            for v, c, x, sids, out in sets:
                err = fn(v.data_ptr(), c.data_ptr(), x.data_ptr(),
                         _lib.x_stride(x), sids.data_ptr(), sids.numel(),
                         v.shape[1], v.shape[2], x.shape[2],
                         out.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

        def check(what):
            for v, c, x, sids, out in sets:
                want = spmv_seg.seg_psum_plain(v, c, x, sids,
                                               torch.empty_like(out))
                scale = spmv_seg.seg_psum_plain(v.abs(), c, x.abs(), sids,
                                                torch.empty_like(out))
                close(torch, out, want, scale, what)
        sweep(torch, case, "CHUNKS_PER_BLOCK", scans, launch, check)

    for label, A, plans in phases:
        for plan_label, plan in plans:
            if plan_label == "cop20k_A/ell":
                continue
            prog = P.lower(A, plan)
            run = P.make_program_spmv_fn(prog, device=dev)
            T = run.operands
            for B in (1, 8):
                x = rng.standard_normal((A.ncols, B)).astype(np.float32)
                bufs = run.buffers(torch.from_numpy(
                    prog.x_to_device(x)).to(dev))
                scan_sets, fixup_sets = [], []
                for pre, xbuf in zip(("loc_", "rem_"), bufs):
                    for fam in ("seg", "split"):
                        if fam not in run.families:
                            continue
                        v, c, pcs, ptr = (T[pre + k] for k in (
                            "seg_vals", "seg_cols", "seg_pieces",
                            "piece_ptr"))
                        sids = run.families[fam]
                        n, R = sids.numel(), ptr.shape[1] - 1
                        psum = spmv_seg.seg_psum(v, c, xbuf, sids)
                        scan_sets.append((v, c, xbuf, sids,
                                          torch.empty_like(psum)))
                        seg = fam == "seg"
                        ns = 1 if seg else int(run.num_splits[pre])
                        ids = sids if seg else torch.arange(
                            n, dtype=torch.int32, device=dev)
                        shape = (v.shape[0], B, R) if seg else (n, B, ns, R)
                        fixup_sets.append((psum, pcs, ptr, sids, ids, ns,
                                           torch.empty(shape, device=dev)))
                scan_sweep(f"{plan_label} B={B}", scan_sets)
                fixup_sweep(f"{plan_label} B={B}", fixup_sets)
        if label != "powerlaw_tail":
            continue
        one = torch.zeros(1, dtype=torch.int32, device=dev)
        for ns in (8, 64):                      # the per-format API's split
            spl = ops.split_from_csr(A, ns)
            NS, Cs, L = spl.vals.shape
            vals, cols = (torch.from_numpy(a).to(dev) for a in (spl.vals,
                                                               spl.cols))
            sp, ch, lo, hi, row = (ops._idx(dev, a) for a in (
                spl.piece_split, spl.piece_chunk, spl.piece_lo,
                spl.piece_hi, spl.piece_row))
            pcs, ptr = ops._piece_table(dev, sp * Cs + ch, lo, hi, row, sp,
                                        L, A.nrows)
            for B in (1, 8):
                xb = torch.from_numpy(np.ascontiguousarray(rng.standard_normal(
                    (B, A.ncols)).astype(np.float32).T)).to(dev)  # (n, B)
                flat = (vals.view(1, NS * Cs, L), cols.view(1, NS * Cs, L))
                for tag, c in (("", flat[1]),
                               (" cols=0", torch.zeros_like(flat[1]))):
                    scan_sweep(f"api/split{ns} B={B}{tag}", [(
                        flat[0], c, xb[None], one,
                        torch.empty((1, B, NS * Cs, L), device=dev))])
                psum = spmv_split.split_psum(vals, cols, xb).view(
                    1, B, NS * Cs, L)
                fixup_sweep(f"api/split{ns} B={B}", [(
                    psum, pcs[None], ptr[None], one, one, NS,
                    torch.empty((1, B, NS, A.nrows), device=dev))])


def rows_cases(torch, dev, rng):
    from repro_torch.core import program as P
    from repro_torch.core.spmv import SpmvPlan
    from repro_torch.data import matrices as mats
    from repro_torch.kernels import _lib, spmv_seg

    consts = ("ROWS_AHEAD", "SCAN_BLOCKS")
    fns = build("spmv_seg.cu", consts,
                [(r, m) for r in (1, 2, 4) for m in (1, 4, 5)],
                ("rt_seg_piece_sums", "rt_seg_psum"))
    M = 471_500
    A = mats.banded(M, 38_800_000, M // 100, seed=0)
    prog = P.lower(A, SpmvPlan(num_shards=8, kernel="seg", exchange="halo"))
    run = P.make_program_spmv_fn(prog, device=dev)
    T, sids = run.operands, run.families["seg"]
    for B in (8, 3):
        x = rng.standard_normal((A.ncols, B)).astype(np.float32)
        sets = []
        for pre, xbuf in zip(("loc_", "rem_"), run.buffers(
                torch.from_numpy(prog.x_to_device(x)).to(dev))):
            v, c, pcs, cptr = (T[pre + k] for k in (
                "seg_vals", "seg_cols", "seg_pieces", "seg_chunk_ptr"))
            d = torch.zeros((sids.numel(), B, pcs.shape[1]), device=dev)
            sets.append((v, c, xbuf, pcs, cptr, d, spmv_seg.seg_piece_sums(
                v, c, xbuf, pcs, cptr, sids, out=torch.zeros_like(d)),
                spmv_seg.seg_psum(v, c, xbuf, sids)))

        def launch(fn, which):
            stream = torch.cuda.current_stream().cuda_stream
            for v, c, x, pcs, cptr, d, _, ps in sets:
                if which == "seg_piece_sums":
                    err = fn[0](v.data_ptr(), c.data_ptr(), x.data_ptr(),
                                _lib.x_stride(x), pcs.data_ptr(),
                                cptr.data_ptr(), sids.data_ptr(),
                                sids.numel(), v.shape[1], v.shape[2],
                                pcs.shape[1], B, d.data_ptr(), stream)
                else:
                    err = fn[1](v.data_ptr(), c.data_ptr(), x.data_ptr(),
                                _lib.x_stride(x), sids.data_ptr(),
                                sids.numel(), v.shape[1], v.shape[2], B,
                                ps.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

        for which in ("seg_piece_sums", "seg_psum"):
            want = [(s[6].clone(), s[7].clone()) for s in sets]

            def check(what, which=which, want=want):
                for s, (d, ps) in zip(sets, want):
                    got, ref = (s[5], d) if which == "seg_piece_sums" \
                        else (s[7], ps)
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{what}: differs from the "
                                             f"library's {which}")
            sweep(torch, f"audikw_1/2 {which} B={B}", consts, fns,
                  lambda fn, which=which: launch(fn, which), check)


def main(argv=None) -> int:
    sweeps = {"contrib": contrib_cases, "tile": tile_cases,
              "general": general_cases, "ell": ell_cases, "seg": seg_cases,
              "rows": rows_cases}
    names = (sys.argv[1:] if argv is None else argv) or list(sweeps)
    if set(names) - set(sweeps):
        print(f"kernel_variants: unknown sweep in {names}; choose from "
              f"{list(sweeps)}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    phases = None
    for name in names:
        if name in ("tile", "general", "rows"):
            sweeps[name](torch, dev, rng)
            continue
        if phases is None:
            phases = [(label, build_matrix(), plans)
                      for label, build_matrix, plans in cs.phases()]
        sweeps[name](torch, dev, rng, phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
