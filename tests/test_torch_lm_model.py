"""The port's whole LM (``repro_torch.models.model`` and the ``Engine``)
against the reference on carried-over parameters, for the dense archs
here and for the others in ``test_torch_lm_model_mixed.py`` and
``test_torch_lm_model_moe.py`` (which import these tests): ``forward``
logits, the ``loss_fn`` value, ``prefill``, eight ``decode_step``s with
their logits and caches, and greedy ``Engine.generate``.  Also the port's
own decode-vs-forward check (``tests/test_models.py``'s, on the port).

The reference's parameters come from ``repro.models.params.init_params``
and reach the port through ``from_reference``; inputs are drawn with
numpy from a seed.  Tolerances, all tighter than the reference's own
decode-vs-forward 0.15 (rtol and atol):

* logits: |port - reference| <= ``ATOL`` + ``RTOL`` |reference|.  Each
  bf16 product and rounding may differ by an ulp between the two (the
  reference's scan body is compiled, with its own order of adds), and
  these compound over the layers: the worst seen at the smoke configs is
  0.069 over 0.02 |reference| (recurrentgemma's decode).
* the loss: ``LOSS_TOL`` absolute (worst seen 2.7e-3 on ~6.7).
* caches: max |port - reference| <= ``CACHE_TOL`` of max |reference| per
  leaf (worst seen 0.017, the xLSTM states after eight steps).

MoE archs carry float32 parameters, as the reference's own decode test
does: with bf16 activations a one-ulp difference can flip a near-tied
top-k expert choice, a discontinuity that no tolerance covers (seen on
deepseek at bf16: 0.48).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import model as rm
from repro.models import params as rp
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

ATOL, RTOL = 0.1, 0.02
LOSS_TOL = 1e-2
CACHE_TOL = 0.05
DECODE_STEPS = 8
GEN_PROMPT, GEN_STEPS = 4, 8


def batch_np(cfg, B=2, S=16, seed=0):
    """tests/test_models.py's smoke batch, drawn with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "encodec_stub":
        return {"frames": rng.standard_normal((B, S, cfg.d_model)),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S, cfg.num_codebooks))}
    if cfg.frontend == "siglip_stub":
        P = cfg.prefix_len
        return {"image_embeds": rng.standard_normal((B, P, cfg.d_model)),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - P)),
                "labels": rng.integers(0, cfg.vocab_size, (B, S - P))}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype.kind == "f"
            else jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def to_port(batch):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            if v.dtype.kind == "f" else torch.from_numpy(v)
            for k, v in batch.items()}


def f32(a):
    return a.float().numpy() if torch.is_tensor(a) else \
        np.asarray(a, np.float32)


def assert_logits(got, want, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    excess = np.abs(got - want) - (ATOL + RTOL * np.abs(want))
    assert excess.max() <= 0, \
        f"{what}: max |diff| {np.abs(got - want).max():.4f}"


def ref_params(arch):
    cfg = ref_smoke(arch)
    params = rp.init_params(cfg, jax.random.PRNGKey(0))
    if cfg.moe is not None:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def run_case(arch):
    """Everything both sides compute for one arch, computed once."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    rparams = ref_params(arch)
    params = tp.from_reference(cfg, jax.tree.map(np.asarray, rparams),
                               device="cpu")
    batch = batch_np(cfg)
    jb, tb = to_jax(batch), to_port(batch)
    out = {"arch": arch, "cfg": cfg, "rcfg": rcfg, "rparams": rparams,
           "params": params}
    out["forward"] = (rm.forward(rparams, rcfg, jb)[0],
                      tm.forward(params, cfg, tb)[0])
    out["loss"] = (float(rm.loss_fn(rparams, rcfg, jb)[0]),
                   float(tm.loss_fn(params, cfg, tb)[0]))
    pb = {k: v for k, v in batch.items() if k != "labels"}
    out["prefill"] = (rm.prefill(rparams, rcfg, to_jax(pb)),
                      tm.prefill(params, cfg, to_port(pb)))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, DECODE_STEPS))
    rc = rm.init_cache(rcfg, 2, 16)
    pc = tm.init_cache(cfg, 2, 16, device="cpu")
    steps = []
    for t in range(DECODE_STEPS):
        a, rc = rm.decode_step(rparams, rcfg, jnp.asarray(toks[:, t: t + 1]),
                               rc, jnp.int32(t))
        b, pc = tm.decode_step(params, cfg, torch.from_numpy(toks[:, t: t + 1]),
                               pc, t)
        steps.append((f32(a), f32(b)))
    out["decode"] = steps
    out["caches"] = (rc, pc)
    return out


@pytest.fixture(scope="module", params=["gemma_7b", "qwen25_32b",
                                        "qwen3_4b", "command_r_plus_104b"])
def case(request):
    return run_case(request.param)


def test_forward_logits(case):
    want, got = case["forward"]
    assert got.dtype == torch.float32
    assert_logits(got, want, case["arch"])


def test_loss_value(case):
    want, got = case["loss"]
    assert np.isfinite(got) and abs(got - want) <= LOSS_TOL, (got, want)


def test_prefill_last_position(case):
    want, got = case["prefill"]
    assert_logits(got, want, case["arch"])
    # and it is the forward's last position
    assert_logits(got, case["forward"][1][:, -1:], "prefill vs forward")


def test_decode_step_logits(case):
    for t, (want, got) in enumerate(case["decode"]):
        assert_logits(got, want, f"{case['arch']} step {t}")


def test_decode_step_caches(case):
    rc, pc = case["caches"]
    ref_leaves = jax.tree.leaves(rc)
    port_leaves = tp.tree_leaves(pc)
    assert len(ref_leaves) == len(port_leaves)
    for i, (w, g) in enumerate(zip(ref_leaves, port_leaves)):
        assert str(g.dtype) == "torch." + np.asarray(w).dtype.name, i
        w, gf = f32(w), f32(g)
        assert gf.shape == w.shape, i
        err = np.abs(gf - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= CACHE_TOL, (i, err)


def test_engine_greedy_matches_reference(case):
    """Greedy tokens equal the reference Engine's at every step but
    near-ties.  A near-tie is a step where the reference's top-2 logits
    lie within twice that row's max |port - reference| of each other (the
    port's logits replayed along the reference's tokens), the most a
    rounding difference can move them apart, so either side may
    legitimately pick the other.  Near-ties are counted and not compared;
    where the tokens did part there, the rest of the row is skipped (its
    paths differ).  At least half the steps must be compared.

    The reference engine's step runs op by op, as every other reference
    call here does: under its ``jax.jit`` XLA may keep excess precision
    where the model rounds to bf16 (``--xla_allow_excess_precision``,
    on by default), which moves its logits away from its own op-by-op
    results (0.042 on deepseek's forward) and flips MoE routes."""
    cfg, rcfg = case["cfg"], case["rcfg"]
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, GEN_PROMPT)).astype(np.int32)
    max_len = GEN_PROMPT + GEN_STEPS + 2
    ref = RefEngine(rcfg, case["rparams"], RefServeConfig(max_len=max_len))
    seen = []

    def step(p, tok, caches, pos):
        logits, caches = rm.decode_step(p, rcfg, tok, caches, pos)
        seen.append(f32(logits[:, 0]))
        return logits, caches

    ref._decode = step
    want = ref.generate(prompts, steps=GEN_STEPS)
    got = Engine(cfg, case["params"], ServeConfig(max_len=max_len),
                 device="cpu").generate(prompts, steps=GEN_STEPS)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :GEN_PROMPT], prompts)
    # the port's logits along the reference's path
    pc = tm.init_cache(cfg, 4, max_len, device="cpu")
    tol = []
    for t in range(GEN_PROMPT + GEN_STEPS - 1):
        b, pc = tm.decode_step(case["params"], cfg,
                               torch.from_numpy(want[:, t: t + 1]), pc, t)
        if t >= GEN_PROMPT - 1:
            a, b = seen[t], f32(b[:, 0])
            if a.ndim == 3:                       # codebook 0's head
                a, b = a[:, 0], b[:, 0]
            assert_logits(b, a, f"replayed step {t}")
            top2 = np.sort(a, axis=-1)[:, -2:]
            tol.append((top2[:, 1] - top2[:, 0],
                        2 * np.abs(b - a).max(axis=-1)))
    compared = near_ties = skipped = 0
    for row in range(4):
        for i, (gap, moved) in enumerate(tol):
            same = got[row, GEN_PROMPT + i] == want[row, GEN_PROMPT + i]
            if gap[row] <= moved[row]:
                near_ties += 1
                if not same:
                    skipped += GEN_STEPS - i - 1
                    break
                continue
            assert same, (row, i)
            compared += 1
    print(f"{case['arch']}: {compared} tokens compared, {near_ties} "
          f"near-ties, {skipped} skipped after a parting")
    assert compared >= 4 * GEN_STEPS // 2, (compared, near_ties, skipped)


# --------------------------------------------------------------------------
# tests/test_models.py's decode-vs-forward check, on the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_4b", "recurrentgemma_2b",
                                  "xlstm_1_3b", "deepseek_moe_16b"])
def test_port_decode_matches_forward(arch):
    """Greedy decode logits == teacher-forced forward logits position-wise,
    with the reference test's tolerance (0.15) and its dropless f32 MoE."""
    cfg = get_smoke_config(arch)
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
        params = tp.tree_map(lambda a: a.float(), params)
    B, S = 2, 8
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    full, _ = tm.forward(params, cfg, {"tokens": toks})
    caches = tm.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, caches = tm.decode_step(params, cfg, toks[:, t: t + 1],
                                        caches, t)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(),
                               full.numpy(), rtol=0.15, atol=0.15)
