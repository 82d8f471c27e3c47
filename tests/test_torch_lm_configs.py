"""The port's LM configurations and parameters against the reference's:
the ten ``CONFIG``s and ``smoke_config()``s field for field, the
registry (aliases, ``grid_cells``, ``input_specs`` and ``abstract_cache``
on the ``meta`` device), the parameter shape and spec tree,
``param_count`` / ``active_param_count``, ``abstract_params``,
``init_params`` and ``from_reference``; and
``tests/test_models.py``'s ``test_grid_cells_count`` and
``test_param_counts_match_nameplates`` run on the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as rreg
from repro.models import model as rm
from repro.models import params as rp
from repro_torch.configs import registry as treg
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from repro_torch.models.config import SHAPES

torch.set_num_threads(1)

ARCHS = treg.ARCH_IDS


def test_arch_ids_and_aliases():
    assert treg.ARCH_IDS == rreg.ARCH_IDS
    assert treg._ALIASES == rreg._ALIASES
    assert treg.get_config("qwen3-4b") is treg.get_config("qwen3_4b")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_field_for_field(arch):
    for port, ref in ((treg.get_config(arch), rreg.get_config(arch)),
                      (treg.get_smoke_config(arch),
                       rreg.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert type(port).__module__ == "repro_torch.models.config"
        if port.moe is not None:
            assert type(port.moe).__module__ == "repro_torch.models.config"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal(arch):
    for port, ref in ((treg.get_config(arch), rreg.get_config(arch)),
                      (treg.get_smoke_config(arch),
                       rreg.get_smoke_config(arch))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_tree_and_specs_equal(arch):
    """Shapes and logical specs of every leaf, as tuples (the reference's
    PartitionSpecs are tuples of the same axis names)."""
    for port_cfg, ref_cfg in ((treg.get_config(arch), rreg.get_config(arch)),
                              (treg.get_smoke_config(arch),
                               rreg.get_smoke_config(arch))):
        def flat(tree, leaf, path=()):
            if leaf(tree):
                return {path: tree}
            out = {}
            for k, v in tree.items():
                out |= flat(v, leaf, path + (k,))
            return out

        is_leaf = tp._is_shape_leaf
        port = flat(tp.model_shape_tree(port_cfg), is_leaf)
        ref = flat(rp.model_shape_tree(ref_cfg), is_leaf)
        assert port.keys() == ref.keys()
        for k in ref:
            assert port[k][0] == ref[k][0], k
            assert tuple(port[k][1]) == tuple(ref[k][1]), k


def test_slstm_inner_equal():
    for arch in ARCHS:
        for f in ("get_config", "get_smoke_config"):
            assert tp.slstm_inner(getattr(treg, f)(arch)) == \
                rp.slstm_inner(getattr(rreg, f)(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_on_meta(arch):
    cfg = treg.get_config(arch)
    port = tp.tree_leaves(tp.abstract_params(cfg))
    ref = jax.tree.leaves(rp.abstract_params(rreg.get_config(arch)))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.device.type == "meta" and a.dtype == torch.bfloat16
        assert tuple(a.shape) == tuple(b.shape)
    assert sum(a.numel() for a in port) == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_cache(arch):
    """Every (arch, shape) cell's inputs: the same shapes and dtypes as
    the reference's ShapeDtypeStructs, as meta tensors."""
    cfg, rcfg = treg.get_config(arch), rreg.get_config(arch)
    for name, shape in SHAPES.items():
        port = treg.input_specs(cfg, shape)
        ref = rreg.input_specs(rcfg, rreg.SHAPES[name])
        pl, rl = tp.tree_leaves(port), jax.tree.leaves(ref)
        assert sorted(port) == sorted(ref)
        assert len(pl) == len(rl)
        for a, b in zip(pl, rl):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), (name, a.shape)
            assert str(a.dtype) == "torch." + jnp.dtype(b.dtype).name


def test_grid_cells_count():
    """Assignment grid: 10 archs x 4 shapes = 40 cells; 8 documented skips."""
    cells = treg.grid_cells()
    assert cells == rreg.grid_cells()
    assert len(cells) == 40
    skips = [(a, s) for a, s, ok in cells if not ok]
    assert len(skips) == 8
    assert all(s == "long_500k" for _, s in skips)


def test_param_counts_match_nameplates():
    expect = {"gemma_7b": (7, 10), "qwen25_32b": (30, 35),
              "command_r_plus_104b": (100, 112), "deepseek_moe_16b": (15, 18),
              "grok_1_314b": (300, 330), "xlstm_1_3b": (1.0, 1.5)}
    for arch, (lo, hi) in expect.items():
        n = treg.get_config(arch).param_count() / 1e9
        assert lo <= n <= hi, f"{arch}: {n:.2f}B outside [{lo}, {hi}]"
    # qwen3-4b, the size the port serves on the card: 4.411 B, 8.8 GB bf16
    n = treg.get_config("qwen3_4b").param_count()
    assert 4.40e9 < n < 4.42e9


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "recurrentgemma_2b",
                                  "deepseek_moe_16b", "musicgen_medium"])
def test_init_params(arch):
    """Drawn from the generator given: the same seed gives the same
    parameters, another seed others; every leaf bf16 (``lam`` included,
    as the reference casts it), with N(0, 1/fan_in) statistics."""
    cfg = treg.get_smoke_config(arch)
    a = tp.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tp.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = tp.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    la, lb, lc = (tp.tree_leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
    assert all(x.dtype == torch.bfloat16 for x in la)
    ref = jax.tree.leaves(rp.init_params(rreg.get_smoke_config(arch),
                                         jax.random.PRNGKey(0)))
    assert [tuple(x.shape) for x in la] == [tuple(x.shape) for x in ref]
    assert all(x.dtype == jnp.bfloat16 for x in ref)
    w = a["embed"].float()
    assert abs(float(w.std()) * np.sqrt(cfg.vocab_size) - 1.0) < 0.05
    if arch == "recurrentgemma_2b":
        assert a["stack"]["u0_rglru"]["lam"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_from_reference_carries_values_and_dtypes(dtype):
    cfg = treg.get_smoke_config("recurrentgemma_2b")
    ref = rp.init_params(rreg.get_smoke_config("recurrentgemma_2b"),
                         jax.random.PRNGKey(1))
    if dtype == "f32":
        ref = jax.tree.map(lambda a: a.astype(jnp.float32) * 1.001, ref)
    port = tp.from_reference(cfg, jax.tree.map(np.asarray, ref),
                             device="cpu")
    want = torch.bfloat16 if dtype == "bf16" else torch.float32
    for r, p in zip(jax.tree.leaves(ref), tp.tree_leaves(port)):
        assert p.dtype == want
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(r, np.float32))
    bad = jax.tree.map(np.asarray, ref)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        tp.from_reference(cfg, bad, device="cpu")


def test_init_cache_matches_reference_dtypes():
    for arch in ARCHS:
        cfg, rcfg = treg.get_smoke_config(arch), rreg.get_smoke_config(arch)
        port = tp.tree_leaves(tm.init_cache(cfg, 2, 24, device="cpu"))
        ref = jax.tree.leaves(rm.init_cache(rcfg, 2, 24))
        assert [tuple(p.shape) for p in port] == [r.shape for r in ref]
        assert [str(p.dtype) for p in port] == \
            ["torch." + r.dtype.name for r in ref]
        assert all(not p.any() for p in port)
