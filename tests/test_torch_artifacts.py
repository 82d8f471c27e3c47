"""The port's program bundles: the reference's format, read and written in
both directions.

A bundle the JAX package writes loads in the port with every stage array
bitwise and the same ``PlanChoice``, and the other way round; the frozen
``tests/fixtures/artifact_bundle_v1`` loads; a digest mismatch, a schema
bump, a torn manifest and a missing bundle raise the port's exceptions;
and the port's executor (``device="cpu"``) answers bitwise the same on a
loaded program as on the original.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core.artifacts as r_art
import repro.core.plan as r_plan
import repro.core.program as r_program
import repro.data.matrices as r_mat
from repro.core.spmv import SpmvPlan as RPlan

import repro_torch.core.artifacts as t_art
import repro_torch.core.plan as t_plan
import repro_torch.core.program as t_program
from repro_torch.core.sparse_matrix import CSRMatrix
from repro_torch.core.spmv import SpmvPlan as TPlan

from test_torch_host import _to_port, assert_same

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PLANS = [
    dict(kernel="ell"), dict(kernel="seg"), dict(kernel="hyb"),
    dict(kernel="split", distribution="row"),
    dict(kernel="tile", layout="cyclic"),
    dict(kernel="seg", reordering="bfs",
         shard_kernels=("ell", "seg", "hyb", "split"),
         split_counts=(1, 1, 1, 2),
         shard_exchanges=("halo", "allgather", "halo", "allgather")),
    dict(kernel="tile", reordering="metis", exchange="allgather",
         shard_kernels=("tile", "tile", "split", "seg")),
]
IDS = ["ell", "seg", "hyb", "split", "tile", "mixed-bfs", "tile-metis"]


def _matrix():
    return r_mat.mixed_structure(256, 256 * 8, seed=1)


def _x(n, B=None):
    rng = np.random.default_rng(11)
    return rng.standard_normal(n if B is None else (n, B))


def _device_cpu(prog, x):
    return t_program.execute(prog, x, backend="device", device="cpu")


def test_structure_digest_matches():
    for A in (_matrix(), r_mat.make_matrix("cop20k_A", scale=0.002, seed=4),
              r_mat.powerlaw_tail(512, 4096, n_monster=2, seed=2)):
        B = _to_port(A)
        assert t_art.structure_digest(B) == r_art.structure_digest(A)
        v = B.values.copy()
        v[0] += 1.0
        assert t_art.structure_digest(CSRMatrix(
            B.shape, v, B.col_index, B.row_ptr)) != r_art.structure_digest(A)
    assert t_art.SCHEMA_VERSION == r_art.SCHEMA_VERSION


@pytest.mark.parametrize("fields", PLANS, ids=IDS)
def test_reference_bundle_loads_in_port(fields, tmp_path):
    A = _matrix()
    B = _to_port(A)
    plan = dict(fields, num_shards=4)
    rprog = r_program.lower(A, RPlan(**plan))
    choice = r_plan.autotune(A, num_shards=4, probe=0)
    r_art.save_program(rprog, str(tmp_path / "b"), source=A, choice=choice)
    got, got_choice = t_art.load_program(str(tmp_path / "b"), expect=B)
    assert isinstance(got, t_program.SpmvProgram)
    assert isinstance(got.plan, TPlan)
    assert_same(rprog, got)
    assert_same(t_program.lower(B, TPlan(**plan)), got)
    assert got_choice.to_json() == choice.to_json()
    X = _x(A.ncols, 3)
    assert np.array_equal(_device_cpu(got, X),
                          _device_cpu(t_program.lower(B, TPlan(**plan)), X))


@pytest.mark.parametrize("fields", PLANS, ids=IDS)
def test_port_bundle_loads_in_reference(fields, tmp_path):
    A = _matrix()
    B = _to_port(A)
    plan = dict(fields, num_shards=4)
    tprog = t_program.lower(B, TPlan(**plan))
    choice = t_plan.autotune(B, num_shards=4, probe=0)
    t_art.save_program(tprog, str(tmp_path / "b"), source=B, choice=choice)
    got, got_choice = r_art.load_program(str(tmp_path / "b"), expect=A)
    assert_same(tprog, got)
    assert got_choice.to_json() == choice.to_json()
    x = _x(A.ncols)
    assert np.array_equal(r_program.execute(got, x),
                          t_program.execute(tprog, x))


@pytest.mark.parametrize("fields", PLANS, ids=IDS)
def test_port_roundtrip_executes_bitwise(fields, tmp_path):
    A = _matrix()
    B = _to_port(A)
    prog = t_program.lower(B, TPlan(**dict(fields, num_shards=4)))
    bundle = t_art.save_program(prog, str(tmp_path / "b"), source=B)
    loaded, choice = t_art.load_program(bundle, expect=B)
    assert choice is None
    assert_same(prog, loaded)
    X = _x(A.ncols, 4)
    for x in (X, X[:, 0]):
        assert np.array_equal(_device_cpu(prog, x), _device_cpu(loaded, x))
        assert np.array_equal(t_program.execute(prog, x),
                              t_program.execute(loaded, x))


def test_frozen_fixture_bundle_loads():
    bundle = os.path.join(FIXTURES, "artifact_bundle_v1")
    A = r_mat.mixed_structure(128, 2500, seed=3)   # the generating matrix
    B = _to_port(A)
    got, choice = t_art.load_program(bundle, expect=B)
    want, r_choice = r_art.load_program(bundle, expect=A)
    assert_same(want, got)
    assert choice.to_json() == r_choice.to_json()
    assert choice.plan == got.plan
    assert_same(t_program.lower(B, got.plan), got)
    x = _x(A.ncols)
    np.testing.assert_allclose(_device_cpu(got, x), r_program.execute(want, x),
                               rtol=2e-4, atol=2e-4)


def _saved(tmp_path):
    B = _to_port(_matrix())
    prog = t_program.lower(B, TPlan(num_shards=4, kernel="seg"))
    return B, t_art.save_program(prog, str(tmp_path / "b"), source=B)


def test_digest_mismatch_raises(tmp_path):
    B, bundle = _saved(tmp_path)
    revalued = CSRMatrix(B.shape, B.values * 1.5, B.col_index, B.row_ptr)
    with pytest.raises(t_art.ArtifactMismatch, match="digest"):
        t_art.load_program(bundle, expect=revalued)
    t_art.load_program(bundle, expect=B)


def test_schema_bump_raises(tmp_path):
    B, bundle = _saved(tmp_path)
    mpath = os.path.join(bundle, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["schema_version"] = t_art.SCHEMA_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(t_art.ArtifactMismatch, match="schema"):
        t_art.load_program(bundle, expect=B)


def test_torn_manifest_reads_as_missing(tmp_path):
    B, bundle = _saved(tmp_path)
    with open(os.path.join(bundle, "manifest.json"), "w") as f:
        f.write('{"format": "spmv-program-bu')
    with pytest.raises(t_art.ArtifactMissing):
        t_art.load_program(bundle, expect=B)


def test_missing_and_invalidated_raise(tmp_path):
    with pytest.raises(t_art.ArtifactMissing):
        t_art.load_program(str(tmp_path / "nope"))
    B, bundle = _saved(tmp_path)
    t_art.invalidate_bundle(bundle)
    with pytest.raises(t_art.ArtifactMissing):
        t_art.load_program(bundle, expect=B)
    assert issubclass(t_art.ArtifactMissing, t_art.ArtifactError)
    assert issubclass(t_art.ArtifactMismatch, t_art.ArtifactError)


def test_reordered_save_needs_source(tmp_path):
    B = _to_port(_matrix())
    prog = t_program.lower(B, TPlan(num_shards=4, reordering="bfs"))
    with pytest.raises(ValueError, match="source"):
        t_art.save_program(prog, str(tmp_path / "never"))
