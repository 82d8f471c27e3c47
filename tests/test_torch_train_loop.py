"""The port's train step and loop (``repro_torch.train.loop``) against the
reference's: three steps of ``make_train_step`` from the same weights
(``from_reference``) and the same ``TokenStream`` batches, beside the
reference's ``step_fn`` (the first return of its ``make_train_step``) run
op by op (``jax.disable_jit``) on a 1x1 mesh, with ``remat`` on, at
``grad_accum`` 1 here and 2 in ``test_torch_train_loop_accum.py``; then
``train_loop``, the one-device placements and the serving step
factories.

Tolerances, from the worst seen on the smoke qwen3 (bf16 weights, lr
3e-4, B = 2, S = 16, at either ``grad_accum``):

* the loss and ``ce`` per step: ``LOSS_TOL`` absolute (worst seen 2.7e-3
  on ~6.9); ``aux`` is 0 on both sides; ``lr`` bitwise.
* ``gnorm``: ``GNORM_RTOL`` (worst seen 2.8e-3: the bf16 gradients
  differ by ulps, see ``test_torch_train_grads.py``).
* the parameters after three steps: each element within ``PARAM_TOL``
  times ``lr * steps``, plus one bf16 ulp of its value, of the
  reference's (worst seen 1.36 ``lr * steps``).  Adam moves an element
  by about ``lr`` a step whatever its gradient's size, so where a
  gradient is near zero next to its rounding difference the two sides
  can step in opposite directions: 2 ``lr`` a step is the most they part
  by before the rounding to bf16, which adds at most an ulp.  The share
  of elements more than one bf16 ulp apart is held under ``MAX_MOVED``
  (worst seen 0.22%).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.data.synthetic import DataConfig as RefDataConfig
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.launch.mesh import auto_axis_types
from repro.optim import adamw as ra
from repro.train import loop as rloop
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.synthetic import DataConfig, TokenStream
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from repro_torch.optim import adamw as ta
from repro_torch.train import loop as tloop
from test_torch_lm_model import ref_params

torch.set_num_threads(1)

LOSS_TOL = 5e-3
GNORM_RTOL = 1e-2
PARAM_TOL = 2.0
MAX_MOVED = 0.01
STEPS = 3
CPU = torch.device("cpu")


def ref_cfg():
    return ra.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)


def run_both(arch, grad_accum):
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_params(arch)
    params = tp.from_reference(cfg, jax.tree.map(np.asarray, rparams),
                               device="cpu")
    ropt, opt = ra.init_state(rparams), ta.init_state(params)
    rmesh = jax.make_mesh((1, 1), ("data", "model"), **auto_axis_types(2))
    r_step, _, _ = rloop.make_train_step(
        rcfg, ref_cfg(), rmesh,
        rloop.RunConfig(fsdp=False, remat=True, donate=False,
                        grad_accum=grad_accum))
    t_step, for_batch, _ = tloop.make_train_step(
        cfg, ta.AdamWConfig(**dataclasses.asdict(ref_cfg())),
        make_host_mesh(device="cpu"),
        tloop.RunConfig(fsdp=False, remat=True, grad_accum=grad_accum))
    data = dict(seed=0, batch=2, seq_len=16)
    rstream = RefTokenStream(rcfg, RefDataConfig(**data))
    stream = TokenStream(cfg, DataConfig(**data))
    key = jax.random.PRNGKey(0)
    metrics = []
    step = for_batch(stream.batch_at(0))
    for s in range(STEPS):
        with jax.disable_jit():
            rparams, ropt, rm = r_step(
                rparams, ropt, {k: jnp.asarray(v) for k, v in
                                rstream.batch_at(s).items()},
                jax.random.fold_in(key, s))
        params, opt, m = step(params, opt, stream.batch_at(s),
                              tloop.step_generator(CPU, s))
        metrics.append(({k: float(v) for k, v in rm.items()},
                        {k: float(v) for k, v in m.items()}))
    return {"metrics": metrics, "params": (rparams, params),
            "opt": (ropt, opt)}


@pytest.fixture(scope="module")
def case():
    return run_both("qwen3_4b", 1)


def test_step_metrics(case):
    for s, (want, got) in enumerate(case["metrics"]):
        assert sorted(got) == sorted(want) == \
            ["aux", "ce", "gnorm", "loss", "lr"]
        for k in ("loss", "ce"):
            assert abs(got[k] - want[k]) <= LOSS_TOL, (s, k, got[k], want[k])
        assert got["aux"] == want["aux"] == 0.0
        assert got["lr"] == want["lr"], s
        np.testing.assert_allclose(got["gnorm"], want["gnorm"],
                                   rtol=GNORM_RTOL, err_msg=str(s))
    print("loss off by", [abs(g["loss"] - w["loss"])
                          for w, g in case["metrics"]],
          "gnorm by", [abs(g["gnorm"] / w["gnorm"] - 1)
                       for w, g in case["metrics"]])


def test_params_after_steps(case):
    rparams, params = case["params"]
    ropt, opt = case["opt"]
    assert int(opt.step) == int(ropt.step) == STEPS
    moved = total = 0
    worst = 0.0
    for w, g in zip(jax.tree.leaves(rparams), tp.tree_leaves(params)):
        assert str(g.dtype) == "torch." + np.asarray(w).dtype.name
        w, g = np.asarray(w, np.float32), g.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        err = np.abs(g - w).max() / (ref_cfg().lr * STEPS)
        worst = max(worst, err)
        assert np.all(np.abs(g - w) <= PARAM_TOL * ref_cfg().lr * STEPS
                      + ulp), err
        moved += int(np.sum(np.abs(g - w) > ulp))
        total += w.size
    print(f"worst {worst:.4f} of lr * steps; {moved} of {total} "
          f"elements more than one bf16 ulp away")
    assert moved <= MAX_MOVED * total


def test_run_config_mirrors_the_reference():
    assert dataclasses.asdict(tloop.RunConfig()) == \
        dataclasses.asdict(rloop.RunConfig())


def test_donate_updates_in_place_and_copies_without():
    cfg = get_smoke_config("qwen3_4b")
    mesh = make_host_mesh(device="cpu")
    batch = TokenStream(cfg, DataConfig(batch=2, seq_len=8)).batch_at(0)
    outs = []
    for donate in (True, False):
        params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        before = tp.tree_map(torch.clone, params)
        opt = ta.init_state(params)
        _, for_batch, _ = tloop.make_train_step(
            cfg, ta.AdamWConfig(warmup_steps=1), mesh,
            tloop.RunConfig(donate=donate))
        new, new_opt, _ = for_batch(batch)(params, opt, batch)
        same = [a is b for a, b in zip(tp.tree_leaves(new),
                                       tp.tree_leaves(params))]
        assert all(same) if donate else not any(same)
        assert int(opt.step) == 0 and int(new_opt.step) == 1
        if not donate:
            for a, b in zip(tp.tree_leaves(params), tp.tree_leaves(before)):
                assert torch.equal(a, b)
        outs.append(new)
    for a, b in zip(*map(tp.tree_leaves, outs)):
        assert torch.equal(a, b)


class FixedStream:
    def __init__(self, batch):
        self.batch = batch

    def batch_at(self, step):
        return self.batch


def test_train_loop_reduces_loss():
    """tests/test_distributed.py's single-device train step, through the
    port's ``train_loop``: remat, grad_accum 2, lr 1e-2, the same batch
    three times; the loss falls."""
    cfg = get_smoke_config("qwen3_4b")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 16))}
    losses = {}
    params, opt, metrics = tloop.train_loop(
        cfg, ta.AdamWConfig(lr=1e-2), make_host_mesh(device="cpu"),
        FixedStream(batch), 3,
        tloop.RunConfig(fsdp=False, remat=True, donate=False, grad_accum=2),
        on_metrics=lambda s, m: losses.__setitem__(s, m["loss"]))
    assert sorted(losses) == [0, 1, 2]
    assert losses[2] < losses[0]
    assert metrics["loss"] == losses[2] and int(opt.step) == 3


def test_straggler_deadline_is_reported():
    cfg = get_smoke_config("qwen3_4b")
    stream = TokenStream(cfg, DataConfig(batch=2, seq_len=8))
    seen = []
    tloop.train_loop(cfg, ta.AdamWConfig(), make_host_mesh(device="cpu"),
                     stream, 2, tloop.RunConfig(step_deadline_s=1e-9),
                     on_metrics=lambda s, m: seen.append(m))
    assert len(seen) == 2 and all(m["straggler"] > 0 for m in seen)


def test_mesh_of_two_devices_raises():
    """A mesh of more than one device never trains quietly on one: without
    a process group over its devices (``tests/test_torch_mesh_train.py``
    trains on such groups) every factory raises."""
    cfg = get_smoke_config("qwen3_4b")
    mesh = Mesh(("data", "model"), (2, 1), (CPU, CPU))
    assert tloop.batch_axes_of(mesh) == ("data",)
    for make in (lambda: tloop.make_train_step(cfg, ta.AdamWConfig(), mesh),
                 lambda: tloop.make_decode_step(cfg, mesh, 2),
                 lambda: tloop.make_prefill_step(cfg, mesh, 2),
                 lambda: tloop.param_shardings(cfg, mesh, tloop.RunConfig())):
        with pytest.raises(RuntimeError, match="without a process group"):
            make()


def test_host_mesh():
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices == (CPU,)
    with pytest.raises(ValueError):
        make_host_mesh(2, device="cpu")


def test_serving_step_factories():
    """``make_decode_step`` and ``make_prefill_step`` run the model's own
    ``decode_step`` and ``prefill`` on the mesh's device."""
    cfg = get_smoke_config("qwen3_4b")
    mesh = make_host_mesh(device="cpu")
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    _, for_batch, p_place = tloop.make_prefill_step(cfg, mesh, 2)
    assert all(s.mesh is mesh and s.mesh.local_device == CPU
               for s in tp.tree_leaves(p_place))
    got = for_batch({"tokens": toks})(params, {"tokens": toks})
    want = tm.prefill(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(got, want)
    serve_step, _, (_, c_place) = tloop.make_decode_step(cfg, mesh, 2)
    caches = tm.init_cache(cfg, 2, 8, device="cpu")
    assert len(tp.tree_leaves(c_place)) == len(tp.tree_leaves(caches))
    ref_caches = tm.init_cache(cfg, 2, 8, device="cpu")
    for t in range(3):
        tok = torch.from_numpy(toks[:, t: t + 1])
        a, caches = serve_step(params, tok, caches, t)
        b, ref_caches = tm.decode_step(params, cfg, tok, ref_caches, t)
        assert torch.equal(a, b)
