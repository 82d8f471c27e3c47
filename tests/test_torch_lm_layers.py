"""The port's LM layers (``repro_torch.models.layers``) against the
reference's on the same inputs: ``rms_norm``, ``rope``, both attentions
(causal, windowed, prefix-LM, softcapped, the ring buffer) and
``ffn_block`` (swiglu and geglu).

Inputs are drawn with numpy from a seed, rounded to bf16 once, and given
to both sides bit for bit.  The reference's elementwise ops and products
round like the port's, so most outputs agree bitwise; a product's order
of adds may differ, so each check allows a few bf16 ulps of the output's
magnitude (``BF16_TOL``: 2e-2 of max |reference|, five ulps of 2^-8).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.models import layers as rl
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import layers as tl

torch.set_num_threads(1)

BF16_TOL = 2e-2
F32_TOL = 1e-4


def bf16(a):
    """A numpy array rounded to bf16, as (jax array, torch tensor)."""
    j = jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
    return j, to_torch(j)


def to_torch(a, device="cpu"):
    """A jax or numpy array as a torch tensor of the same dtype (bf16
    through float32, which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def scaled_err(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    g = got.detach().float().cpu().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.isfinite(g).all()
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def assert_scaled(got, want, tol, what=""):
    err = scaled_err(got, want)
    assert err <= tol, f"{what}: scaled error {err:.3g} > {tol}"


def test_rms_norm_scales_by_one_plus_scale():
    rng = np.random.default_rng(0)
    jx, tx = bf16(rng.standard_normal((2, 8, 64)) * 3)
    js, ts = bf16(rng.standard_normal(64) * 0.1)
    got = tl.rms_norm(tx, ts)
    assert got.dtype == torch.bfloat16
    assert_scaled(got, rl.rms_norm(jx, js), BF16_TOL, "rms_norm")
    # zero scale is the identity gain (1 + 0), not a zero output
    z = tl.rms_norm(tx, torch.zeros(64, dtype=torch.bfloat16))
    assert z.abs().max() > 0.5


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_rotates_halves(theta):
    rng = np.random.default_rng(1)
    jx, tx = bf16(rng.standard_normal((2, 12, 4, 16)))
    pos = np.tile(np.arange(3, 15), (2, 1))
    got = tl.rope(tx, torch.from_numpy(pos), theta)
    assert_scaled(got, rl.rope(jx, jnp.asarray(pos), theta), BF16_TOL, "rope")
    # halves: feature 0 pairs with feature D/2 (not feature 1)
    e = torch.zeros(1, 1, 1, 16)
    e[..., 0] = 1.0
    r = tl.rope(e, torch.tensor([[1]]), 1.0)
    assert r[..., 8].abs() > 0.5 and r[..., 1] == 0


ATTN_CASES = {
    "causal": dict(),
    "windowed": dict(window=5),
    "prefix_lm": dict(prefix_len=6),
    "softcap": dict(softcap=2.0),
    "chunks_padded": dict(chunk=8),          # T = 20: 3 chunks, 4 padded
    "gqa_window_chunks": dict(window=7, chunk=6),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention(case):
    rng = np.random.default_rng(2)
    jq, tq = bf16(rng.standard_normal((2, 20, 4, 16)))
    jk, tk = bf16(rng.standard_normal((2, 20, 2, 16)))
    jv, tv = bf16(rng.standard_normal((2, 20, 2, 16)))
    kw = ATTN_CASES[case]
    want = rl.chunked_attention(jq, jk, jv, **kw)
    got = tl.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    assert_scaled(got, want, BF16_TOL, case)


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention(window, per_row):
    rng = np.random.default_rng(3)
    jq, tq = bf16(rng.standard_normal((3, 1, 4, 16)))
    jk, tk = bf16(rng.standard_normal((3, 12, 2, 16)))
    jv, tv = bf16(rng.standard_normal((3, 12, 2, 16)))
    length = np.array([5, 9, 12], np.int32) if per_row else 9
    want = rl.decode_attention(jq, jk, jv, jnp.asarray(length),
                               softcap=3.0, window=window)
    got = tl.decode_attention(
        tq, tk, tv, torch.from_numpy(length) if per_row else length,
        softcap=3.0, window=window)
    assert_scaled(got, want, BF16_TOL, "decode_attention")


def _attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd), "wo": (qd, d),
              "bq": (qd,), "bk": (kvd,), "bv": (kvd,),
              "q_norm": (cfg.head_dim,), "k_norm": (cfg.head_dim,)}
    out = {k: bf16(rng.standard_normal(s) / np.sqrt(s[0]))
           for k, s in shapes.items()}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen25_32b", "paligemma_3b"])
def test_attention_block_prefill(arch):
    """qk_norm (qwen3), the QKV bias (qwen2.5), prefix-LM MQA (paligemma)."""
    cfg = get_smoke_config(arch)
    jp, tp = _attn_params(cfg, 4)
    rng = np.random.default_rng(5)
    jx, tx = bf16(rng.standard_normal((2, 12, cfg.d_model)))
    pos = np.tile(np.arange(12), (2, 1))
    want, (wk, wv) = rl.attention_block(jp, jx, ref_smoke(arch),
                                        jnp.asarray(pos), prefix_len=3)
    got, (gk, gv) = tl.attention_block(tp, tx, cfg, torch.from_numpy(pos),
                                       prefix_len=3)
    assert_scaled(got, want, BF16_TOL, "out")
    assert_scaled(gk, wk, BF16_TOL, "k")
    assert_scaled(gv, wv, BF16_TOL, "v")


@pytest.mark.parametrize("T,window", [(16, None), (6, 6), (4, 6), (16, 6)],
                         ids=["full", "ring_eq", "ring_lt", "windowed"])
def test_attention_block_decode_cache(T, window):
    """Ten decode steps through a cache of T slots: a full cache, ring
    buffers (T <= window: slot = pos % T) and a windowed full cache.  The
    port writes the cache in place; both caches must agree after every
    step."""
    arch = "recurrentgemma_2b"
    cfg = get_smoke_config(arch)
    jp, tp = _attn_params(cfg, 6)
    rng = np.random.default_rng(7)
    shape = (2, T, cfg.num_kv_heads, cfg.head_dim)
    jc = (jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16))
    tc = (torch.zeros(shape, dtype=torch.bfloat16),
          torch.zeros(shape, dtype=torch.bfloat16))
    for t in range(10):
        jx, tx = bf16(rng.standard_normal((2, 1, cfg.d_model)))
        pos = np.full((2, 1), t)
        want, jc = rl.attention_block(jp, jx, ref_smoke(arch),
                                      jnp.asarray(pos), window=window,
                                      kv_cache=jc, cache_len=jnp.int32(t))
        got, out_c = tl.attention_block(tp, tx, cfg, torch.from_numpy(pos),
                                        window=window, kv_cache=tc,
                                        cache_len=t)
        assert out_c[0] is tc[0] and out_c[1] is tc[1]   # in place
        assert_scaled(got, want, BF16_TOL, f"out step {t}")
        assert_scaled(tc[0], jc[0], BF16_TOL, f"k cache step {t}")
        assert_scaled(tc[1], jc[1], BF16_TOL, f"v cache step {t}")


@pytest.mark.parametrize("activation", ["swiglu", "geglu"])
def test_ffn_block(activation):
    rng = np.random.default_rng(8)
    shapes = {"w_gate": (64, 128), "w_up": (64, 128), "w_down": (128, 64)}
    p = {k: bf16(rng.standard_normal(s) / np.sqrt(s[0]))
         for k, s in shapes.items()}
    jx, tx = bf16(rng.standard_normal((2, 10, 64)) * 2)
    want = rl.ffn_block({k: v[0] for k, v in p.items()}, jx, activation)
    got = tl.ffn_block({k: v[1] for k, v in p.items()}, tx, activation)
    assert_scaled(got, want, BF16_TOL, activation)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; the erf form differs by up
    to ~4e-4 on [-3, 3], far above f32 rounding."""
    x = np.linspace(-3, 3, 601).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    np.testing.assert_allclose(tanh.numpy(), want, rtol=0, atol=2e-6)
    assert np.abs(erf.numpy() - want).max() > 1e-4


def test_mixed_dtype_products_promote_like_jnp():
    """bf16 activations times f32 weights compute in f32, as jnp does."""
    rng = np.random.default_rng(9)
    jx, tx = bf16(rng.standard_normal((2, 4, 64)))
    w = rng.standard_normal((64, 32)).astype(np.float32)
    want = jnp.einsum("bsd,df->bsf", jx, jnp.asarray(w))
    got = tl.linear(tx, torch.from_numpy(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_scaled(got, want, F32_TOL, "linear")
