"""The three-step parity tests of ``test_torch_train_loop.py`` at
``grad_accum = 2``: two micro-batches a step, their gradients summed in
float32 (``acc + g / 2``, as the reference's scan does), and the
reference's metrics (``ce`` the mean loss, ``aux`` 0).  The tolerances
and their reasons are stated there.  Then the Valiant shuffle under
gradient accumulation."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.synthetic import DataConfig, TokenStream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tp
from repro_torch.optim import adamw as ta
from repro_torch.train import loop as tloop
from test_torch_train_loop import run_both
from test_torch_train_loop import test_params_after_steps  # noqa: F401
from test_torch_train_loop import test_step_metrics  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return run_both("qwen3_4b", 2)


def test_shuffle_draws_one_permutation_a_step(monkeypatch):
    """With the Valiant shuffle on, every micro-batch of a step (and the
    recompute of each checkpointed unit) gets the same permutation, as the
    reference hands every micro-batch the step's one key; the next step's
    generator draws another."""
    cfg = get_smoke_config("deepseek_moe_16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, valiant_shuffle=True))
    seen = []
    real = tmoe.moe_ffn

    def recording(*args, perm=None, **kw):
        seen.append(perm)
        return real(*args, perm=perm, **kw)
    monkeypatch.setattr("repro_torch.models.model.moe_ffn", recording)
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = ta.init_state(params)
    _, for_batch, _ = tloop.make_train_step(
        cfg, ta.AdamWConfig(warmup_steps=1), make_host_mesh(device="cpu"),
        tloop.RunConfig(fsdp=False, remat=True, grad_accum=2))
    stream = TokenStream(cfg, DataConfig(batch=4, seq_len=8))
    step = for_batch(stream.batch_at(0))
    n_moe = cfg.num_layers - cfg.dense_first_layers
    perms = []
    for s in range(2):
        seen.clear()
        params, opt, m = step(params, opt, stream.batch_at(s),
                              tloop.step_generator(torch.device("cpu"), s))
        assert len(seen) == 2 * n_moe * 2      # micro-batches x recompute
        assert all(torch.equal(p, seen[0]) for p in seen)
        assert np.isfinite(float(m["loss"]))
        perms.append(seen[0])
    assert not torch.equal(perms[0], perms[1])
    assert not torch.equal(perms[0], torch.arange(perms[0].numel()))
