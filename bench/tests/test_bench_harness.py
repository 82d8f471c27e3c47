"""CPU tests of the benchmark's harness: ``python -m pytest -q bench/tests``.

The yardstick (the compulsory bound, the reference, the frozen
generators), the contract of ``BENCHMARK.json``, every file found by
name, a rehearsal of every cell on the CPU through ``run_cell``, the
command's refusal without a card, and the faults the check has to catch.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import bound, cell, matrices, named, reference, system, traffic  # noqa: E402,E501

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
#: Rehearsal sizes: a few thousand rows of each configuration.
SCALE = {"audikw_1": 0.005, "rmat": 0.02}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def rehearse(workload, root=REPO, *, trace=False, seconds=0.5,
             seed=2**31 + 12345):
    conf = cell.load_cell(workload, root)["cell"]["config"]
    return cell.run_cell(workload, seed, seconds, trace, device="cpu",
                         scale=SCALE[conf], root=root)


# -- the yardstick --------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 8])
def test_bound_against_hand_counts(block):
    # 3 x 4 matrix, 5 nonzeros: values and columns 5 * 8 B, row pointers
    # 4 * 4 B, x 4 * 4 B a column, y 3 * 4 B a column; 2 FLOP a product.
    b = bound.bound_s(3, 4, 5, block)
    assert b["bytes"] == 40 + 16 + 16 * block + 12 * block
    assert b["flops"] == 10 * block
    assert b["binds"] == "bytes"
    assert b["s"] == b["bytes"] / 3.35e12
    full = bound.bound_s(943_000, 943_000, 78_700_000)
    assert full["s"] == pytest.approx(641.3e6 / 3.35e12, rel=1e-3)


def _small_csr(seed=3):
    return matrices.generator("banded").generate(300, 4000, 20, seed=seed)


def _dense(csr):
    A = np.zeros(csr.shape)
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.row_ptr))
    A[rows, csr.col_index] = csr.values
    return A


@pytest.mark.parametrize("k", [1, 8])
def test_reference_against_dense_product(k, monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_ELEMS", 512)     # many blocks
    csr = _small_csr()
    A = _dense(csr)
    X = np.random.default_rng(0).standard_normal((300, k))
    ref = reference.Reference(csr, "cpu")
    got = ref.matmul(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, A @ X, rtol=1e-12, atol=1e-12)
    got = ref.matmul(torch.from_numpy(X), absolute=True).numpy()
    np.testing.assert_allclose(got, np.abs(A) @ np.abs(X), rtol=1e-12)
    ctrl = ref.matmul(torch.from_numpy(X), dtype=torch.bfloat16).numpy()
    bf = (torch.from_numpy(A).to(torch.bfloat16).float()
          @ torch.from_numpy(X).to(torch.bfloat16).float()).double().numpy()
    np.testing.assert_allclose(ctrl, bf, rtol=1e-5, atol=1e-5)


def test_norm_error():
    want = torch.tensor([[1.0, 2.0], [3.0, -4.0]], dtype=torch.float64)
    scale = torch.tensor([[2.0, 2.0], [4.0, 8.0]], dtype=torch.float64)
    got = want + torch.tensor([[0.1, 0.0], [0.0, 0.4]])
    assert reference.norm_error(got, want, scale) == pytest.approx(0.05)
    got[0, 0] = float("nan")
    assert reference.norm_error(got, want, scale) == float("inf")
    assert reference.norm_error(want, want, torch.zeros_like(want)) == 0.0
    with pytest.raises(ValueError):
        reference.norm_error(want[:1], want, scale)


def _program_generators():
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.data import matrices as program_matrices
    return program_matrices


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
@pytest.mark.parametrize("sort_device", [None, "cpu"])
def test_frozen_generators_bitwise_the_programs(seed, sort_device):
    pm = _program_generators()
    banded, rmat = (matrices.generator(n).generate for n in ("banded", "rmat"))
    pairs = [
        (banded(2000, 30_000, 20, seed=seed, sort_device=sort_device),
         pm.banded(2000, 30_000, 20, seed=seed)),
        (rmat(3000, 40_000, seed=seed, sort_device=sort_device),
         pm.rmat(3000, 40_000, seed=seed)),
    ]
    for ours, theirs in pairs:
        assert ours.shape == tuple(theirs.shape)
        for f in ("values", "col_index", "row_ptr"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["audikw_1", "rmat"])
def test_config_matrix_is_the_programs_suite_entry(name):
    pm = _program_generators()
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    M, nnz, _ = pm.PAPER_SUITE[name]
    assert (conf["matrix"]["M"], conf["matrix"]["nnz"]) == (M, nnz)
    if name == "audikw_1":
        assert conf["matrix"]["bandwidth"] == max(M // 100, 8)


# -- traffic ----------------------------------------------------------------------

def test_vectors_follow_the_seed():
    a = traffic.vectors(100, 2, 8, seed=5, device="cpu")
    b = traffic.vectors(100, 2, 8, seed=5, device="cpu")
    c = traffic.vectors(100, 2, 8, seed=6, device="cpu")
    assert a[0].shape == (100, 8) and a[0].dtype == torch.float32
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert traffic.vectors(100, 1, 1, seed=5, device="cpu")[0].shape == (100,)


# -- BENCHMARK.json and the files it names -------------------------------------

def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
        names.append(c["name"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
        for w in m.get("workloads", []):
            assert w in CELLS
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in [c["name"] for c in SPEC["configs"]]
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        names.append(w["name"])
        reported = [m["name"] for m in SPEC["end_to_end"]
                    if w["name"] in m.get("workloads", CELLS)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m.get("workloads", CELLS)
                   for m in SPEC["per_layer"])
    assert len(pairs) == len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= 1
    for n in names:
        assert NAME.match(n), n
    for text in [c["source"] for c in SPEC["configs"]] + \
            [x["why"] for x in SPEC["configs"] + SPEC["workloads"]] + \
            [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_files_by_name(workload):
    spec = cell.load_cell(workload)
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == spec["cell"]["config"])
    conf = json.loads((REPO / entry["file"]).read_text())
    assert conf == spec["config"] and conf["name"] == entry["name"]
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert callable(matrices.generator(conf["matrix"]["generator"]).generate)
    kind = traffic.kind(spec["mix"]["kind"])
    for f in ("setup", "window", "counters", "answers"):
        assert callable(getattr(kind, f))
    assert conf["limit"]["norm_err"] > 0
    for m in spec["per_layer"]:
        assert callable(cell.reader(m["name"]))


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(KeyError):
        traffic.kind("no_such_kind")
    with pytest.raises(KeyError):
        matrices.generator("../benchlib/cell")
    with pytest.raises(ValueError, match="unknown keys"):
        traffic.load("extra", _bench_copy_with(
            {"traffic/extra.json": '{"kind": "closed", "vectors": 1, '
             '"block": 1, "sample": 1, "rate": 3}'}, tmp_path))


def _bench_copy_with(files: dict, tmp: Path) -> Path:
    """A copy of ``bench/`` (its tests left out) in ``tmp``, with
    ``files`` added."""
    dst = tmp / "bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for rel, text in files.items():
        assert not (dst / rel).exists(), rel
        (dst / rel).write_text(text)
    return dst


NEW_CELL = {
    "generators/ring.py": (
        '"""A ring: every row holds its diagonal and its two neighbours."""\n'
        "import numpy as np\n"
        "from benchlib.matrices import finish\n\n\n"
        "def generate(M, nnz, *, seed=0, sort_device=None):\n"
        "    rng = np.random.default_rng(seed)\n"
        "    r = np.repeat(np.arange(M), 3)\n"
        "    c = (r + np.tile([-1, 0, 1], M)) % M\n"
        "    return finish(r, c, rng.standard_normal(3 * M), M, False,\n"
        "                  sort_device)\n"),
    "configs/ring.json": json.dumps({
        "name": "ring", "source": "a ring", "reduced": [], "assumed": [],
        "matrix": {"generator": "ring", "M": 4096, "nnz": 12288},
        "plan": {"reordering": "none", "layout": "block",
                 "distribution": "row", "exchange": "halo", "kernel": "seg",
                 "num_shards": 4, "seed": 0},
        "precision": "float32", "limit": {"norm_err": 1e-5}}),
    "traffic/pairs.json": json.dumps({
        "kind": "closed", "vectors": 2, "block": 2, "sample": 3,
        "why": "two (N, 2) blocks back to back"}),
    "metrics/calls_per_s.py": (
        '"""Calls a second of the traced window."""\n\n\n'
        "def read(ctx):\n"
        "    tr = ctx['trace']\n"
        "    if not tr:\n"
        "        return None\n"
        "    return ctx['counters']['traced_calls'] / tr['window_s']\n"),
}


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_cell_is_new_files_alone(trace, tmp_path, monkeypatch):
    """A configuration with a new generator, a mix and a per-layer metric
    added as files, and entries added to ``BENCHMARK.json``: the cell runs
    and reads correct, and no file of the harness changed."""
    dst = _bench_copy_with(NEW_CELL, tmp_path)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "ring", "source": "a ring",
                            "file": "bench/configs/ring.json",
                            "reduced": [], "why": "a ring"})
    spec["workloads"].append({"name": "ring.pairs", "config": "ring",
                              "traffic": "pairs", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        m.get("workloads", []).append("ring.pairs")
    spec["per_layer"].append({
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "executor call",
        "moves": "call_us", "workloads": ["ring.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(named, "BENCH", dst)
    out = cell.run_cell("ring.pairs", 5, 0.3, trace, device="cpu",
                        root=tmp_path)
    assert out["correct"] is True and out["attempted"] > 0
    want = {"calls_per_s"} if trace else \
        {"setup_s", "call_us"}
    assert set(out["metrics"]) == want
    for f in BENCH.rglob("*"):
        rel = f.relative_to(BENCH)
        if f.is_file() and "tests" not in rel.parts \
                and "__pycache__" not in rel.parts:
            assert (dst / rel).read_bytes() == f.read_bytes(), rel


# -- rehearsals on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_of_every_cell(workload, trace):
    spec = cell.load_cell(workload)
    out = rehearse(workload, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["checks"]["norm_err"]["value"] < 1e-6
    if trace:
        # the device's readers find nothing on the CPU and stay silent
        host_side = {m["name"] for m in spec["per_layer"]
                     if m["source"] != "device_trace"}
        assert set(out["metrics"]) == host_side
    else:
        assert set(out["metrics"]) == {m["name"]
                                       for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_no_run_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'bench'); "
            "from benchlib import cell; "
            "cell.run_cell('rmat.solve', 3, 0.2, True, device='cpu', "
            "scale=0.02); print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "repro" in cell.FORBIDDEN and "jax" in cell.FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", None)
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", None)
    assert "repro" in cell.forbidden_modules()


def test_command_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "rmat.solve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA device" in out.stderr


# -- the faults the check has to catch ---------------------------------------------

def _broken_executor(fault):
    program_mod = system.import_program()[0]
    real = program_mod.make_program_spmv_fn

    def make(prog, *args, **kwargs):
        run = real(prog, *args, **kwargs)
        prev = {}

        def broken(x):
            y = run(x).clone()
            if fault == "altered":
                y[0, 0] += 1.0                 # a real row of shard 0
            elif fault == "half_batch":
                y[..., y.shape[-1] // 2:] = 0.0
            elif fault == "unchanged":
                y, prev["y"] = prev.get("y", y), y
            return y
        for attr in ("prime", "graph_stats", "program", "buffers", "mesh",
                     "axis", "operands"):
            setattr(broken, attr, getattr(run, attr))
        return broken
    return program_mod, make


def _no_exchange(program_mod):
    real = program_mod._index_exchange

    def exchange(prog, ops, dev):
        start = real(prog, ops, dev)
        per = prog.x_layout.padded_length() // prog.plan.num_shards

        def start_without(xb):
            finish = start(xb)

            def without():
                buf = finish().clone()
                buf[:, :, per:] = 0.0          # the halo never arrives
                return buf
            return without
        return start_without
    return exchange


@pytest.mark.parametrize("fault", ["altered", "unchanged", "exchange",
                                   "half_batch"])
@pytest.mark.parametrize("workload", ["audikw_1.solve", "audikw_1.block8",
                                      "rmat.solve"])
def test_closed_loop_faults_read_incorrect(workload, fault, monkeypatch):
    if fault == "half_batch" and not workload.endswith("block8"):
        pytest.skip("a B = 1 call has no half a batch to leave out")
    program_mod, make = _broken_executor(fault)
    if fault == "exchange":
        monkeypatch.setattr(program_mod, "_index_exchange",
                            _no_exchange(program_mod))
    else:
        monkeypatch.setattr(program_mod, "make_program_spmv_fn", make)
    out = rehearse(workload)
    assert out["correct"] is False
    assert out["checks"]["norm_err"]["value"] > \
        out["checks"]["norm_err"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_incorrect(workload):
    """The reference in bfloat16, put in the program's place, fails the
    limit that the program's answers keep (at a rehearsal's size)."""
    spec = cell.load_cell(workload)
    conf, mix = spec["config"], spec["mix"]
    csr = matrices.make_matrix(conf["matrix"], seed=77,
                               scale=SCALE[conf["name"]])
    ref = reference.Reference(csr, "cpu")
    block = mix.get("block", 1)
    X = traffic.vectors(csr.shape[1], 1, block, seed=77, device="cpu",
                        dtype=torch.float64)[0].reshape(csr.shape[1], -1)
    want, scale = ref.matmul(X), ref.matmul(X, absolute=True)
    ctrl = ref.matmul(X, dtype=torch.bfloat16)
    err = reference.norm_error(ctrl, want, scale)
    assert err > 3 * conf["limit"]["norm_err"]


class _Event:
    def __init__(self, name, device, start, dur, annotation=False):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_trace_reduction_on_a_known_timeline():
    from benchlib import trace
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("bench.call", cpu, 0, 1000),
        _Event("bench.call", cuda, 100, 900, annotation=True),
        _Event("void (anonymous namespace)::seg_psum_kernel<1>(float*)",
               cuda, 100, 200),
        _Event("Memcpy DtoD (Device -> Device)", cuda, 250, 100),
        _Event("cudaGraphLaunch", cpu, 400, 300),
        _Event("seg_fixup_kernel<1>(float*)", cuda, 800, 200),
    ]
    r = trace.reduce_events(events, window_s=1e-6)
    assert r["device_events"] == 3
    assert r["busy_s"] == pytest.approx(450e-9)      # [100, 350) + [800, 1000)
    assert r["device_op_s"] == pytest.approx(500e-9)
    assert r["device_ops"][0] == ["seg_psum_kernel<1>", pytest.approx(2e-7)]
    assert r["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(450e-9)]]
    assert trace.reduce_events(events[:1], 1.0) == {"window_s": 1.0,
                                                    "device_events": 0}


def test_a_traced_run_profiles_the_start_of_a_closed_window(monkeypatch):
    from benchlib import trace
    monkeypatch.setattr(trace, "TRACE_S", 0.1)
    seen = {}

    def reader(name):
        def read(ctx):
            seen.update(ctx["counters"], window_s=ctx["trace"]["window_s"])
        return read
    monkeypatch.setattr(cell, "reader", reader)
    out = rehearse("rmat.solve", trace=True, seconds=1.5)
    assert out["correct"] is True
    assert 0 < seen["traced_calls"] < seen["calls"] == out["attempted"]
    # the profiler stops at the first call's end past 0.1 s, long before
    # the window's 1.5 s, however long a call takes on a busy CPU
    assert 0.1 <= seen["window_s"] < 0.75


def _main_lines(module, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("config", ["audikw_1", "rmat"])
def test_the_control_tool_reads_both_sides(config):
    import control
    rows = _main_lines(control, ["--config", config, "--seconds", "0.3",
                                 "--scale", str(SCALE[config]), "--device",
                                 "cpu", "--seeds", "3", "4"])
    cells = [r for r in rows if "cell" in r]
    want = {w["name"] for w in SPEC["workloads"] if w["config"] == config}
    assert {r["cell"] for r in cells} == want
    assert len(cells) == 2 * len(want)
    assert len(rows) == len(cells) + 2             # a traffic line a seed
    for r in cells:
        assert r["program"] <= r["limit"] < r["control"], r
