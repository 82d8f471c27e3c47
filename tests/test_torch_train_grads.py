"""Gradients of the port's ``loss_fn`` (``torch.autograd.grad``) against
``jax.grad`` of the reference's, leaf by leaf, on the reference's
parameters carried over with ``from_reference``: the dense archs
(MusicGen's frame frontend and PaliGemma's prefix LM among them) here,
the others in ``test_torch_train_grads_mixed.py`` and
``test_torch_train_grads_moe.py`` (which import these tests).  Also the
port's ``remat``: bitwise the gradients without it.

The reference runs op by op (``jax.disable_jit``: its layer scan a Python
loop), never under ``jit``, where XLA keeps excess precision where the
model rounds to bf16.  Tolerances, from the worst seen at the smoke
configs:

* the loss: ``LOSS_TOL`` absolute (worst seen 6.5e-4 on ~6.9, qwen3).
* each gradient leaf: max |port - reference| <= ``GRAD_TOL`` of the
  leaf's max |reference| (worst seen 0.040, xLSTM's sLSTM ``w_in``: bf16
  gradients, each product rounded once more or less in one framework or
  the other), and ||port - reference|| <= ``GRAD_NORM_TOL`` of
  ||reference|| (worst seen 0.026, the same arch).  A leaf the loss does not
  read (MusicGen's embedding table under its frame frontend) is zero on
  both sides.

MoE archs carry float32 parameters, as the reference's own decode test
does: a one-ulp change can flip a near-tied expert choice.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import model as rm
from repro.train.checkpoint import _flatten_with_names
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from test_torch_lm_model import batch_np, ref_params, to_jax, to_port

torch.set_num_threads(1)

LOSS_TOL = 5e-3
GRAD_TOL = 0.06
GRAD_NORM_TOL = 0.04


def port_grads(params, cfg, batch, **kw):
    live = tp.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = tm.loss_fn(live, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, tp.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def grad_case(arch):
    """Both sides' loss and gradients for one arch, computed once."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_params(arch)
    params = tp.from_reference(cfg, jax.tree.map(np.asarray, rparams),
                               device="cpu")
    batch = batch_np(cfg)
    jb = to_jax(batch)
    with jax.disable_jit():
        (rloss, _), rgrads = jax.value_and_grad(
            lambda p: rm.loss_fn(p, rcfg, jb), has_aux=True)(rparams)
    names, rleaves, _ = _flatten_with_names(rgrads)
    loss, _, grads = port_grads(params, cfg, to_port(batch))
    return {"arch": arch, "loss": (float(rloss), float(loss)),
            "names": names, "grads": (rleaves, grads),
            "params": params}


@pytest.fixture(scope="module", params=["qwen3_4b", "gemma_7b",
                                        "musicgen_medium", "paligemma_3b"])
def case(request):
    return grad_case(request.param)


def test_loss_matches(case):
    want, got = case["loss"]
    assert np.isfinite(got) and abs(got - want) <= LOSS_TOL, (got, want)


def test_grads_leaf_by_leaf(case):
    rleaves, grads = case["grads"]
    params = tp.tree_leaves(case["params"])
    assert len(rleaves) == len(grads) == len(params)
    worst = worst_norm = 0.0
    for name, w, g, p in zip(case["names"], rleaves, grads, params):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        w, g = np.asarray(w, np.float32), g.float().numpy()
        assert np.isfinite(g).all(), name
        if not np.any(w):
            assert not np.any(g), name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        err_norm = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_TOL, (name, err)
        assert err_norm <= GRAD_NORM_TOL, (name, err_norm)
        worst, worst_norm = max(worst, err), max(worst_norm, err_norm)
    print(f"{case['arch']}: worst leaf {worst:.4f} of its max, "
          f"{worst_norm:.4f} in norm")


# --------------------------------------------------------------------------
# remat: bitwise the gradients without it
# --------------------------------------------------------------------------

def smoke_inputs(arch):
    cfg = get_smoke_config(arch)
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    if cfg.moe is not None:
        params = tp.tree_map(lambda a: a.float(), params)
    return cfg, params, to_port(batch_np(cfg, seed=1))


@pytest.mark.parametrize("arch", ["qwen3_4b", "recurrentgemma_2b",
                                  "xlstm_1_3b", "paligemma_3b",
                                  "deepseek_moe_16b"])
def test_remat_is_bitwise(arch):
    """Checkpointed pattern units recompute the same ops: the loss, its
    parts (the MoE aux loss returned by each unit) and every gradient
    are bitwise those without remat."""
    cfg, params, batch = smoke_inputs(arch)
    l0, m0, g0 = port_grads(params, cfg, batch)
    l1, m1, g1 = port_grads(params, cfg, batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in ("ce", "aux"))
    if cfg.moe is not None:
        assert float(m0["aux"]) > 0
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_runs_the_units_under_checkpoint(monkeypatch):
    """``remat`` puts every stacked unit, and only those, under
    ``torch.utils.checkpoint`` (prefix and tail layers are not)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_moe_16b"),
                              num_layers=4)
    calls = []
    real = tm.checkpoint

    def counting(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)
    monkeypatch.setattr(tm, "checkpoint", counting)
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = to_port(batch_np(cfg))
    tm.loss_fn(params, cfg, batch)
    assert calls == []
    tm.loss_fn(params, cfg, batch, remat=True)
    _, n_units, _ = tm._layout(cfg)
    assert n_units == cfg.num_layers - cfg.dense_first_layers
    assert calls == [False] * n_units
