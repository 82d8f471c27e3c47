"""The SpMV executor over a ``torch.distributed`` mesh, on gloo CPU ranks.

Three multi-rank runs (``tests/torch_mesh_ranks.py``'s ``run_ranks``,
each rank its own process), one ("model",) mesh over a world of 4, 2 and
1 ranks, all on ``cop20k_A`` at scale 0.003 with S = 4 shards:

* against the reference: the cases of ``tests/test_program.py``'s
  four-device run (4 bases x 4 kernel mixes), through
  ``execute(..., backend="shard_map", mesh=...)`` on 4 ranks, within
  ``TOL`` of the reference's ``shard_map`` executor on 4 host devices (its
  jnp oracle, and its Pallas kernels in interpret mode on the het+tile
  cases; one subprocess) and of float64 ``csr_matvec``;
* against the port's one-device executor, bitwise: every rank's block
  and gathered y at W = 4, 2 (two shards a rank) and 1, at B = 1 and 3,
  with ``pipeline`` on and off, on a halo, an all-gather, a mixed-exchange
  and a reordered plan;
* per rank: the operands hold S/W shards of what the block's kernel
  families read, and the exchange sends (S/W)·S·H·4·B bytes (halo) or
  (S/W)·per·4·B (all-gather), the y gather (S/W)·R·4·B, counted on the
  collectives;
* the errors (W not dividing S, a CUDA executor on a gloo group,
  ``graphs=True`` on a distributed mesh) and the legacy shims with the
  reference's positional mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.data.matrices as r_mat
from repro.core.sparse_matrix import csr_matvec

import repro_torch.core.program as t_program
from repro_torch.core.spmv import SpmvPlan as TPlan
from repro_torch.launch.mesh import Mesh
from test_torch_program import TOL, uploaded
import torch_mesh_ranks as tr

torch.set_num_threads(1)

MATRIX = ("cop20k_A", 0.003)
S = 4
SEED = 1
#: The reference four-device run's cross-section (tests/test_program.py):
#: exchange, layout, distribution x the per-shard kernel mixes.
BASES = (("allgather", "block", "row"), ("allgather", "cyclic", "nonzero"),
         ("halo", "block", "nonzero"), ("halo", "cyclic", "row"))
MIXES = {"seg": None, "het": ("ell", "seg", "hyb", "seg"),
         "het+split": ("ell", "split", "hyb", "seg"),
         "het+tile": ("tile", "seg", "split", "tile")}
REF = {f"{e}/{lay}/{d}/{tag}": dict(
    matrix=MATRIX, seed=SEED, B=None,
    plan=dict(exchange=e, layout=lay, distribution=d, kernel="seg",
              shard_kernels=sk, num_shards=S))
    for e, lay, d in BASES for tag, sk in MIXES.items()}
REF["halo/block/nonzero/het+tile/B3"] = dict(
    REF["halo/block/nonzero/het+tile"], B=3)
#: The reference cases also run with its Pallas kernels in interpret mode.
PALLAS = [k for k in REF if "het+tile" in k]
#: Plans held bitwise to the one-device executor at every world size.
EXEC = {
    "halo": dict(exchange="halo", shard_kernels=("ell", "split", "hyb",
                                                 "seg")),
    "allgather-cyclic": dict(exchange="allgather", layout="cyclic",
                             distribution="row",
                             shard_kernels=("tile", "seg", "split", "tile")),
    "mixed": dict(shard_exchanges=("halo", "allgather", "halo",
                                   "allgather"),
                  shard_kernels=("tile", "split", "hyb", "seg")),
    "bfs": dict(reordering="bfs", exchange="halo",
                shard_kernels=("seg", "tile", "ell", "split")),
}
EXEC = {k: dict(matrix=MATRIX, seed=SEED + 1,
                plan=dict(dict(num_shards=S, kernel="seg"), **v))
        for k, v in EXEC.items()}
SHIM = dict(matrix=MATRIX, seed=SEED + 2, B=3,
            plan=dict(num_shards=S, kernel="seg", layout="cyclic"))
SHIMS = ("make_spmv_fn", "make_seg_spmv_fn", "make_halo_spmv_fn")
WORLDS = (4, 2, 1)
#: Seconds the reference's subprocess may take.
REF_TIMEOUT = 300

_REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json, sys, warnings
    import jax, numpy as np
    from repro.core import spmv as rs
    from repro.core.program import execute, gather_b, lower
    from repro.core.spmv import SpmvPlan
    from repro.data.matrices import make_matrix
    from repro.launch.mesh import auto_axis_types

    spec = json.loads(sys.argv[1])
    xs = np.load(sys.argv[2])
    mesh = jax.make_mesh((4,), ("model",), **auto_axis_types(1))
    out = {}
    for key, case in spec["cases"].items():
        name, scale = case["matrix"]
        prog = lower(make_matrix(name, scale=scale), SpmvPlan(**case["plan"]))
        x = xs[key]
        out[key] = execute(prog, x, backend="shard_map", mesh=mesh)
        if key in spec["pallas"]:
            out["pallas:" + key] = execute(
                prog, x, backend="shard_map", mesh=mesh, use_kernel=True,
                interpret=True)
    case = spec["shim"]
    name, scale = case["matrix"]
    prog = lower(make_matrix(name, scale=scale), SpmvPlan(**case["plan"]))
    xd = prog.x_to_device(xs["shim"].astype(np.float32))
    halo = rs.build_halo(prog)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ys = {"make_spmv_fn": rs.make_spmv_fn(prog, mesh)(
                  prog.data, prog.cols, xd),
              "make_seg_spmv_fn": rs.make_seg_spmv_fn(prog, mesh, "model")(
                  prog.seg_vals, prog.seg_cols, prog.seg_rows,
                  prog.seg_pieces, xd),
              "make_halo_spmv_fn": rs.make_halo_spmv_fn(prog, halo, mesh)(
                  prog.data, halo.cols_remap, halo.send_idx, xd)}
    for name, y in ys.items():
        out["shim:" + name] = gather_b(prog, np.asarray(y))
    np.savez(sys.argv[3], **out)
""")


def _x(case):
    A = tr.spmv_matrix(case["matrix"])
    return tr.spmv_x(A.ncols, case["B"], case["seed"])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``shard_map`` executor (and shims) on 4 host
    devices, in a subprocess: key -> y."""
    tmp = tmp_path_factory.mktemp("reference")
    xs = {k: _x(c) for k, c in REF.items()}
    xs["shim"] = _x(SHIM)
    np.savez(tmp / "x.npz", **xs)
    spec = {"cases": REF, "pallas": PALLAS, "shim": SHIM}
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, json.dumps(spec),
                        str(tmp / "x.npz"), str(tmp / "y.npz")],
                       capture_output=True, text=True, timeout=REF_TIMEOUT,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp / "y.npz") as f:
        return dict(f)


def _items(W):
    items = [("exec", c) for c in EXEC.values()]
    if W > 1:
        items.append(("errors", dict(matrix=MATRIX)))
    if W == 4:
        items += [("ref", c) for c in REF.values()] + [("shim", SHIM)]
    return items


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """W -> each rank's results of ``_items(W)``, by kind and key."""
    out = {}
    for W in WORLDS:
        tmp = tmp_path_factory.mktemp(f"world{W}")
        res = tr.run_ranks(W, tr.spmv_cases, (_items(W),), tmp)
        keys = list(EXEC) + (["errors"] if W > 1 else []) + \
            (list(REF) + ["shim"] if W == 4 else [])
        out[W] = [dict(zip(keys, r)) for r in res]
    return out


def _program(case):
    A = tr.spmv_matrix(case["matrix"])
    return A, t_program.lower(A, TPlan(**case["plan"]))


def _scaled_err(x, y):
    """The |A|·|x|-scaled error of y against float64 ``csr_matvec`` on
    the reference's matrix."""
    A = r_mat.make_matrix(MATRIX[0], scale=MATRIX[1])
    absA = dataclasses.replace(A, values=np.abs(A.values))
    scale = 1.0 + csr_matvec(absA, np.abs(x))
    return float((np.abs(y - csr_matvec(A, x)) / scale).max())


def test_port_matrix_is_the_reference_matrix():
    A = tr.spmv_matrix(MATRIX)
    R = r_mat.make_matrix(MATRIX[0], scale=MATRIX[1])
    for f in ("values", "col_index", "row_ptr"):
        np.testing.assert_array_equal(getattr(A, f), getattr(R, f))


@pytest.mark.parametrize("key", list(REF))
def test_four_ranks_match_the_reference_shard_map(reference, worlds, key):
    """Every rank's y within ``TOL`` of the reference's ``shard_map``
    executor (jnp oracle) on the same plan and x, and of float64
    ``csr_matvec`` (|A|·|x|-scaled)."""
    x = _x(REF[key])
    for r in worlds[4]:
        np.testing.assert_allclose(r[key], reference[key], atol=TOL,
                                   rtol=TOL)
        assert _scaled_err(x, r[key]) <= TOL


@pytest.mark.parametrize("key", PALLAS)
def test_four_ranks_match_the_reference_pallas_kernels(reference, worlds,
                                                       key):
    """The same against the reference's Pallas kernels in interpret
    mode, through its ``shard_map`` executor."""
    for r in worlds[4]:
        np.testing.assert_allclose(r[key], reference["pallas:" + key],
                                   atol=TOL, rtol=TOL)


_ONE = {}


def one_device(key, B, pipeline):
    """The port's one-device CPU executor on ``EXEC[key]``: (y shards, y)."""
    if (key, B, pipeline) not in _ONE:
        A, prog = _program(EXEC[key])
        x = tr.spmv_x(A.ncols, B, EXEC[key]["seed"])
        xp = x if prog.perm is None else t_program._apply_perm(x, prog.perm)
        run = t_program.make_program_spmv_fn(prog, device="cpu",
                                             pipeline=pipeline)
        y = run(prog.x_to_device(xp.astype(np.float32)))
        _ONE[key, B, pipeline] = (y.numpy(), t_program.gather_b(prog, y))
    return _ONE[key, B, pipeline]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "serial"])
@pytest.mark.parametrize("B", [None, 3], ids=["B1", "B3"])
@pytest.mark.parametrize("key", list(EXEC))
@pytest.mark.parametrize("W", WORLDS)
def test_ranks_are_the_one_device_executor(worlds, W, key, B, pipeline):
    """Each rank's block of y shards and the gathered y equal the port's
    one-device executor bitwise, pipelined or not."""
    shards, y = one_device(key, B, pipeline)
    n = S // W
    for rank, r in enumerate(worlds[W]):
        got = r[key][B, pipeline]
        assert got["shards"] == (rank * n, (rank + 1) * n)
        np.testing.assert_array_equal(got["block"],
                                      shards[rank * n: (rank + 1) * n])
        np.testing.assert_array_equal(got["y"], y)


@pytest.mark.parametrize("key", list(EXEC))
@pytest.mark.parametrize("W", WORLDS)
def test_each_rank_holds_its_block_and_sends_its_share(worlds, W, key):
    """Operands of S/W shards a rank, only those its block's kernel
    families read; the exchange's all-to-all sends (S/W)·S·H·4·B bytes
    when a shard reads a halo, else the all-gather (S/W)·per·4·B; the y
    gather (S/W)·R·4·B."""
    A, prog = _program(EXEC[key])
    ops = t_program._device_operands(prog)
    per = prog.x_layout.padded_length() // S
    halo = "halo" in prog.plan.resolved_shard_exchanges()
    n = S // W
    for rank, r in enumerate(worlds[W]):
        block = set(prog.shard_kernels()[rank * n: (rank + 1) * n])
        for (B, _), got in r[key].items():
            b = B or 1
            assert set(got["operand_rows"].values()) == {n}
            assert set(got["operand_rows"]) == uploaded(block)
            want = {"all-to-all": n * S * ops["halo_H"] * 4 * b if halo
                    else 0,
                    "all-gather": 0 if halo else n * per * 4 * b}
            assert got["sent"] == want
            assert got["gathered"] == {"all-to-all": 0,
                                       "all-gather": n * ops["R"] * 4 * b}


@pytest.mark.parametrize("W", [w for w in WORLDS if w > 1])
def test_misuse_raises(worlds, W):
    """W not dividing S, a CUDA executor on a gloo group and
    ``graphs=True`` on a distributed mesh each raise ``ValueError``."""
    for r in worlds[W]:
        err = r["errors"]
        assert f"{W + 1} shards do not split over {W} ranks" in \
            err["indivisible"]
        assert "nccl" in err["cuda_on_gloo"] and \
            "gloo" in err["cuda_on_gloo"]
        assert "graphs=True" in err["graphs"]


@pytest.mark.parametrize("name", SHIMS)
def test_shims_take_the_reference_mesh(reference, worlds, name):
    """``make_spmv_fn(prog, mesh)``, ``make_seg_spmv_fn(prog, mesh,
    "model")`` and ``make_halo_spmv_fn(prog, halo, mesh)`` on 4 ranks
    answer as the reference's shims on 4 devices."""
    for r in worlds[4]:
        got = r["shim"][name]
        np.testing.assert_allclose(got, reference["shim:" + name],
                                   atol=TOL, rtol=TOL)
        assert _scaled_err(_x(SHIM), got) <= TOL


def test_local_mesh_of_one_device_is_the_one_device_executor():
    """No process group: a local mesh of one device runs the one-device
    path, bitwise, through every entry point."""
    A, prog = _program(EXEC["mixed"])
    mesh = Mesh(("model",), (1,), (torch.device("cpu"),))
    x = tr.spmv_x(A.ncols, 3, 5)
    want = t_program.execute(prog, x, backend="device", device="cpu")
    np.testing.assert_array_equal(
        t_program.execute(prog, x, backend="shard_map", mesh=mesh), want)
    run = t_program.make_program_spmv_fn(prog, mesh)
    assert run.shards == (0, S) and run.mesh is None
    np.testing.assert_array_equal(t_program.device_spmv(run, x), want)


def test_mesh_arguments_checked_without_a_group():
    """A local mesh of two devices, an abstract mesh, an axis the mesh
    lacks, a device that is not the mesh's and ``shard_map`` without a
    mesh all raise."""
    _, prog = _program(EXEC["halo"])
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="local mesh of 2 devices"):
        t_program.make_program_spmv_fn(prog, Mesh(("model",), (2,),
                                                  (cpu, cpu)))
    with pytest.raises(ValueError, match="abstract"):
        t_program.make_program_spmv_fn(prog, Mesh(("model",), (4,), ()))
    one = Mesh(("model",), (1,), (cpu,))
    with pytest.raises(ValueError, match="'data'"):
        t_program.make_program_spmv_fn(prog, one, "data")
    with pytest.raises(ValueError, match="not the mesh's"):
        t_program.make_program_spmv_fn(prog, one, device="cuda")
    with pytest.raises(ValueError, match="needs a mesh"):
        t_program.execute(prog, np.ones(prog.matrix.ncols),
                          backend="shard_map")
