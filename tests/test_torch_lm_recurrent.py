"""The port's recurrent blocks against the reference's on the same inputs:
Griffin (``causal_conv1d``, the RG-LRU scan and step, ``rglru_block``) and
xLSTM (``mlstm_chunked``, ``mlstm_step``, ``mlstm_block``,
``slstm_block``), over a full sequence, from a carried state, and one
decode step at a time, with the returned states.

Tolerances: bf16 outputs within ``BF16_TOL`` of their magnitude (a few
bf16 ulps); the f32 states within ``F32_TOL`` relative.  The RG-LRU scan
is log-depth on both sides but combines in another order (the
reference's ``associative_scan`` against the port's Hillis-Steele
doubling), and the chunked mLSTM sums in another order than the
reference's compiled scan body, so neither is bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import griffin as rg
from repro.models import xlstm as rx
from repro.models import params as rp
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import griffin as tg
from repro_torch.models import xlstm as tx

from test_torch_lm_layers import BF16_TOL, F32_TOL, assert_scaled, bf16

torch.set_num_threads(1)


def _block_params(arch, kind, seed):
    """Random bf16 block parameters at the smoke config's shapes."""
    cfg = ref_smoke(arch)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, _) in rp.block_shapes(cfg, kind).items():
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) > 1 else 0.5
        out[k] = bf16(rng.standard_normal(shape) * scale)
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def _assert_state(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if np.asarray(w).dtype == np.float32:
            assert g.dtype == torch.float32, (what, i, g.dtype)
            assert_scaled(g, w, F32_TOL, f"{what} state {i}")
        else:
            assert_scaled(g, w, BF16_TOL, f"{what} state {i}")


# --------------------------------------------------------------------------
# Griffin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d(carried):
    rng = np.random.default_rng(0)
    jx, tx_ = bf16(rng.standard_normal((2, 7, 16)))
    jk, tk = bf16(rng.standard_normal((4, 16)) * 0.5)
    js, ts = bf16(rng.standard_normal((2, 3, 16))) if carried else (None,
                                                                      None)
    wy, ws = rg.causal_conv1d(jx, jk, js)
    gy, gs = tg.causal_conv1d(tx_, tk, ts)
    assert_scaled(gy, wy, BF16_TOL, "y")
    assert_scaled(gs, ws, BF16_TOL, "state")


@pytest.mark.parametrize("S", [1, 5, 16, 33])
@pytest.mark.parametrize("carried", [False, True])
def test_rg_lru_scan(S, carried):
    rng = np.random.default_rng(S)
    u, r, i = (bf16(rng.standard_normal((2, S, 24))) for _ in range(3))
    lam = bf16(rng.standard_normal(24))
    h0 = rng.standard_normal((2, 24)).astype(np.float32) if carried else None
    wh, wl = rg._rg_lru_scan(u[0], r[0], i[0], lam[0],
                             None if h0 is None else jnp.asarray(h0))
    gh, gl = tg._rg_lru_scan(u[1], r[1], i[1], lam[1],
                             None if h0 is None else torch.from_numpy(h0))
    assert gh.dtype == torch.bfloat16 and gl.dtype == torch.float32
    assert_scaled(gh, wh, BF16_TOL, "h")
    assert_scaled(gl, wl, F32_TOL, "h_last")


def test_rg_lru_step_matches_and_continues_the_scan():
    rng = np.random.default_rng(1)
    u, r, i = (bf16(rng.standard_normal((2, 24))) for _ in range(3))
    lam = bf16(rng.standard_normal(24))
    h = rng.standard_normal((2, 24)).astype(np.float32)
    wh, wl = rg._rg_lru_step(u[0], r[0], i[0], lam[0], jnp.asarray(h))
    gh, gl = tg._rg_lru_step(u[1], r[1], i[1], lam[1], torch.from_numpy(h))
    assert_scaled(gh, wh, BF16_TOL, "h")
    assert_scaled(gl, wl, F32_TOL, "state")
    # one step from h equals a length-1 scan carried from h
    sh, sl = tg._rg_lru_scan(u[1][:, None], r[1][:, None], i[1][:, None],
                             lam[1], torch.from_numpy(h))
    assert torch.equal(sl, gl)


def test_rglru_block_full_and_decode():
    arch = "recurrentgemma_2b"
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    jp, tp = _block_params(arch, "rglru", 2)
    rng = np.random.default_rng(3)
    jx, tx_ = bf16(rng.standard_normal((2, 12, cfg.d_model)))
    want, wstate = rg.rglru_block(jp, jx, rcfg)
    got, gstate = tg.rglru_block(tp, tx_, cfg)
    assert_scaled(got, want, BF16_TOL, "full")
    _assert_state(gstate, wstate, "full")
    # then four decode steps from the carried state
    for t in range(4):
        jx, tx_ = bf16(rng.standard_normal((2, 1, cfg.d_model)))
        want, wstate = rg.rglru_block(jp, jx, rcfg, wstate, decode=True)
        got, gstate = tg.rglru_block(tp, tx_, cfg, gstate, decode=True)
        assert_scaled(got, want, BF16_TOL, f"decode {t}")
        _assert_state(gstate, wstate, f"decode {t}")


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------

def _mlstm_inputs(S, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (bf16(rng.standard_normal((2, S, 2, 8)) * 0.5)
               for _ in range(3))
    ig = rng.uniform(0.05, 0.95, (2, S, 2)).astype(np.float32)
    fg = rng.uniform(0.5, 0.999, (2, S, 2)).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("S,chunk", [(16, 256), (24, 8), (32, 4)])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunked(S, chunk, carried):
    q, k, v, ig, fg = _mlstm_inputs(S, S + chunk)
    rng = np.random.default_rng(5)
    st = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
          rng.standard_normal((2, 2, 8)).astype(np.float32)) \
        if carried else None
    wh, ws = rx.mlstm_chunked(
        q[0], k[0], v[0], jnp.asarray(ig), jnp.asarray(fg),
        None if st is None else tuple(map(jnp.asarray, st)), chunk=chunk)
    gh, gs = tx.mlstm_chunked(
        q[1], k[1], v[1], torch.from_numpy(ig), torch.from_numpy(fg),
        None if st is None else tuple(map(torch.from_numpy, st)),
        chunk=chunk)
    assert_scaled(gh, wh, BF16_TOL, "h")
    _assert_state(gs, ws, "chunked")


def test_mlstm_chunked_raises_when_chunk_does_not_divide():
    q, k, v, ig, fg = _mlstm_inputs(12, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tx.mlstm_chunked(q[1], k[1], v[1], torch.from_numpy(ig),
                         torch.from_numpy(fg), chunk=8)
    with pytest.raises(ValueError, match="not divisible"):
        rx.mlstm_chunked(q[0], k[0], v[0], jnp.asarray(ig), jnp.asarray(fg),
                         chunk=8)


def test_mlstm_step():
    q, k, v, ig, fg = _mlstm_inputs(1, 6)
    rng = np.random.default_rng(7)
    st = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32),
          rng.standard_normal((2, 2, 8)).astype(np.float32))
    wh, ws = rx.mlstm_step(q[0], k[0], v[0], jnp.asarray(ig),
                           jnp.asarray(fg), tuple(map(jnp.asarray, st)))
    gh, gs = tx.mlstm_step(q[1], k[1], v[1], torch.from_numpy(ig),
                           torch.from_numpy(fg),
                           tuple(map(torch.from_numpy, st)))
    assert_scaled(gh, wh, BF16_TOL, "h")
    _assert_state(gs, ws, "step")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_full_and_decode(kind):
    arch = "xlstm_1_3b"
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    jp, tp = _block_params(arch, kind, 8)
    ref_fn, port_fn = {"mlstm": (rx.mlstm_block, tx.mlstm_block),
                       "slstm": (rx.slstm_block, tx.slstm_block)}[kind]
    rng = np.random.default_rng(9)
    jx, tx_ = bf16(rng.standard_normal((2, 16, cfg.d_model)))
    want, wstate = ref_fn(jp, jx, rcfg)
    got, gstate = port_fn(tp, tx_, cfg)
    assert_scaled(got, want, BF16_TOL, "full")
    _assert_state(gstate, wstate, "full")
    for t in range(4):
        jx, tx_ = bf16(rng.standard_normal((2, 1, cfg.d_model)))
        want, wstate = ref_fn(jp, jx, rcfg, wstate, decode=True)
        got, gstate = port_fn(tp, tx_, cfg, gstate, decode=True)
        assert_scaled(got, want, BF16_TOL, f"decode {t}")
        _assert_state(gstate, wstate, f"decode {t}")


def test_mlstm_block_chunk_choice():
    """The block's chunk is min(max(256, S // 32), 1024): S = 300 takes
    chunk 256, which does not divide it, so both sides raise; S = 512
    runs two chunks."""
    arch = "xlstm_1_3b"
    cfg, rcfg = get_smoke_config(arch), ref_smoke(arch)
    jp, tp = _block_params(arch, "mlstm", 11)
    rng = np.random.default_rng(12)
    jx, tx_ = bf16(rng.standard_normal((1, 300, cfg.d_model)))
    with pytest.raises(ValueError, match="not divisible by chunk 256"):
        tx.mlstm_block(tp, tx_, cfg)
    with pytest.raises(ValueError, match="not divisible by chunk 256"):
        rx.mlstm_block(jp, jx, rcfg)
    jx, tx_ = bf16(rng.standard_normal((1, 512, cfg.d_model)))
    want, _ = rx.mlstm_block(jp, jx, rcfg)
    got, _ = tx.mlstm_block(tp, tx_, cfg)
    assert_scaled(got, want, BF16_TOL, "S=512")
