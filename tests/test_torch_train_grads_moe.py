"""The gradient parity tests of ``test_torch_train_grads.py`` for the MoE
archs (DeepSeekMoE, Grok with its logit softcap) on float32 parameters,
and the Valiant shuffle under ``remat``.  The tolerances and their
reasons are stated there."""
import dataclasses

import pytest
import torch

from repro_torch.models import moe as tmoe
from test_torch_train_grads import grad_case, port_grads, smoke_inputs
from test_torch_train_grads import test_grads_leaf_by_leaf  # noqa: F401
from test_torch_train_grads import test_loss_matches  # noqa: F401


@pytest.fixture(scope="module", params=["deepseek_moe_16b", "grok_1_314b"])
def case(request):
    return grad_case(request.param)


def test_valiant_shuffle_under_remat(monkeypatch):
    """With the shuffle on, the recompute of a checkpointed unit sees the
    permutation its forward saw (one draw a pass, outside the units), so
    the gradients with ``remat`` equal those without, bitwise, from the
    same generator seed; and every MoE layer got that one permutation."""
    cfg, params, batch = smoke_inputs("deepseek_moe_16b")
    cfg = dataclasses.replace(cfg, num_layers=3, moe=dataclasses.replace(
        cfg.moe, valiant_shuffle=True))
    seen = []
    real = tmoe.moe_ffn

    def recording(*args, perm=None, **kw):
        seen.append(perm)
        return real(*args, perm=perm, **kw)
    monkeypatch.setattr("repro_torch.models.model.moe_ffn", recording)
    runs = []
    for remat in (False, True):
        seen.clear()
        runs.append(port_grads(params, cfg, batch, remat=remat,
                               generator=torch.Generator().manual_seed(7)))
        n_moe = cfg.num_layers - cfg.dense_first_layers
        # remat: each unit's forward, then its recompute
        assert len(seen) == n_moe * (1 + remat)
        assert all(torch.equal(p, seen[0]) for p in seen)
        assert not torch.equal(seen[0], torch.arange(seen[0].numel()))
    (l0, m0, g0), (l1, m1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
