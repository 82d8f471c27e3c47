"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: ``model_flops``, ``_n_units`` and ``_partial_unroll`` on
every (arch, shape); the cell grid with its skips; and the per-device
parameter and Adam-state bytes of every (arch, shape, mesh) cell, the
reference's side by arithmetic from its own ``param_specs`` and
``abstract_params`` (not from ``memory_analysis()``, which counts XLA's
temporaries).  Then ``main()`` on a few cells, writing its JSON.
"""
import json
import os

import numpy as np
import pytest

import jax

from repro.configs.registry import ARCH_IDS as REF_ARCHS
from repro.configs.registry import get_config as ref_config
from repro.models import params as rparams
from repro.models.config import SHAPES as REF_SHAPES
from repro.models.config import shape_applicable as ref_applicable
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES, shape_applicable

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512
    fake devices: the flag is put back so that later subprocesses do not
    inherit it."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """The port's whole grid, both meshes, through ``main``."""
    path = tmp_path_factory.mktemp("dry") / "grid.json"
    dryrun.main(["--multi-pod", "both", "--json", str(path)])
    with open(path) as f:
        return json.load(f)


def test_flops_units_and_unroll(ref_dryrun):
    assert list(ARCH_IDS) == list(REF_ARCHS)
    assert list(SHAPES) == list(REF_SHAPES)
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert dryrun._n_units(cfg) == ref_dryrun._n_units(rcfg)
        assert dryrun._partial_unroll(cfg) == ref_dryrun._partial_unroll(rcfg)
        for name in SHAPES:
            assert dryrun.model_flops(cfg, SHAPES[name]) == \
                ref_dryrun.model_flops(rcfg, REF_SHAPES[name])


def test_grid_and_skips(grid):
    """Every cell: ok on both meshes where the shape applies, one skip
    with the reference's reason where it does not; no fail."""
    seen = {}
    for r in grid:
        seen.setdefault((r["arch"], r["shape"]), []).append(r)
    assert len(seen) == len(ARCH_IDS) * len(SHAPES)
    for arch in ARCH_IDS:
        rcfg = ref_config(arch)
        for name in SHAPES:
            rows = seen[(arch, name)]
            if ref_applicable(rcfg, REF_SHAPES[name]):
                assert shape_applicable(get_config(arch), SHAPES[name])
                assert sorted(r["mesh"] for r in rows) == ["16x16",
                                                           "2x16x16"]
                assert all(r["status"] == "ok" for r in rows)
            else:
                assert [r["status"] for r in rows] == ["skip"]
                assert rows[0]["reason"] == (
                    "quadratic attention @500k "
                    "(docs/ARCHITECTURE.md#design-5)")
    assert not [r for r in grid if r["status"] == "fail"]


def ref_bytes(arch, shape):
    """The reference's choice of FSDP for the cell (``lower_cell``), and
    the per-device bytes of its parameters (bf16) and of m and v (f32,
    with the int32 step), on each mesh, from its specs by arithmetic."""
    rcfg = ref_config(arch)
    fsdp = rcfg.param_count() > 8e9
    if shape.kind == "decode":
        fsdp = rcfg.param_count() * 2 / 16 > 10e9
    specs = jax.tree.leaves(rparams.param_specs(rcfg, fsdp=fsdp),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    shapes = [a.shape for a in jax.tree.leaves(rparams.abstract_params(rcfg))]
    out = {}
    for mesh, sizes in MESHES.items():
        n = 0
        for shp, spec in zip(shapes, specs):
            spec = tuple(spec) + (None,) * (len(shp) - len(spec))
            parts = [int(np.prod([sizes[a] for a in (
                () if e is None else e if isinstance(e, tuple) else (e,))]))
                for e in spec]
            n += int(np.prod([-(-d // p) for d, p in zip(shp, parts)]))
        out[mesh] = (fsdp, 2 * n, 8 * n + 4)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bytes_per_device(grid, arch):
    for r in grid:
        if r["arch"] != arch or r["status"] != "ok":
            continue
        fsdp, params, state = ref_bytes(arch, SHAPES[r["shape"]])[r["mesh"]]
        assert r["fsdp"] == fsdp, r["shape"]
        assert r["bytes_per_device"]["params"] == params, (r["shape"],
                                                           r["mesh"])
        if SHAPES[r["shape"]].kind == "train":
            assert r["bytes_per_device"]["opt_state"] == state
            assert r["grad_accum"] == 8


def test_main_on_a_few_cells(tmp_path, capsys):
    path = tmp_path / "cells.json"
    res = dryrun.main(["--arch", "qwen3_4b", "--shape", "train_4k",
                       "--multi-pod", "both", "--json", str(path),
                       "--unroll"])
    assert [r["mesh"] for r in res] == ["16x16", "2x16x16"]
    with open(path) as f:
        assert json.load(f) == res
    with open(str(path) + "l") as f:
        assert [json.loads(line) for line in f] == res
    for r in res:
        assert r["status"] == "ok" and r["cost_pass"] == "analytic(u=4,n=36)"
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert r["chips"] == (512 if r["mesh"] == "2x16x16" else 256)
        # a device does its batch shard's share, less the tensor-parallel
        # layers' share over "model"
        shards = 16 if r["mesh"] == "16x16" else 32
        assert r["model_flops_total"] / r["chips"] < \
            r["flops_per_device"] < r["model_flops_total"] / shards
        assert r["tp_layers"] == 36            # qwen3-4b's FFNs
    out = dryrun.main(["--arch", "gemma_7b", "--shape", "long_500k"])
    assert [r["status"] for r in out] == ["skip"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "0 ok / 0 fail / 1 skip"
