"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's on the same inputs: ``route``, ``moe_ffn`` under both
combines, with ``expert_split`` 2 and 4, a capacity drop and the Valiant
shuffle, ``shared_ffn``, ``expert_load`` and ``_capacity``; and
``tests/test_moe_split.py`` run on the port.

Routing is a discontinuity: a top-k choice near a tie flips on one ulp.
The inputs here reach the port bit for bit, the router runs in f32 on
both sides and ties go to the lower expert id, so every routing decision
must agree exactly; the expert products round as the reference's do,
and the outputs may differ by a few bf16 ulps (``BF16_TOL``) or f32
roundings (``F32_TOL``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as rmoe
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig

from test_torch_lm_layers import BF16_TOL, F32_TOL, assert_scaled, bf16, \
    to_torch

torch.set_num_threads(1)


def _cfgs(**kw):
    return RefMoEConfig(**kw), MoEConfig(**kw)


def _weights(E, d, f, seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    j = {k: jnp.asarray(rng.standard_normal(s) * 0.1, dtype)
         for k, s in shapes.items()}
    return j, {k: to_torch(v) for k, v in j.items()}


def _split(p, E, d, f, sp):
    """The reference test's exact decomposition into E * sp thin experts."""
    fs = f // sp
    return {"router": p["router"],
            "w_gate": p["w_gate"].reshape(E, d, sp, fs).transpose(
                0, 2, 1, 3).reshape(E * sp, d, fs),
            "w_up": p["w_up"].reshape(E, d, sp, fs).transpose(
                0, 2, 1, 3).reshape(E * sp, d, fs),
            "w_down": p["w_down"].reshape(E, sp, fs, d).reshape(E * sp, fs, d)}


def test_capacity_matches():
    for T in (1, 4, 32, 1000):
        for cf in (1.0, 1.25, 16.0):
            r, t = _cfgs(num_experts=8, top_k=2, capacity_factor=cf)
            assert tmoe._capacity(T, t) == rmoe._capacity(T, r)


def test_route_matches_and_breaks_ties_low():
    jp, tp = _weights(8, 32, 16, 0, jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((24, 32)).astype(np.float32)
    x[5] = 0.0                       # every logit 0: a full tie
    r, t = _cfgs(num_experts=8, top_k=3)
    w1, i1, z1 = rmoe.route(jp, jnp.asarray(x), r)
    w2, i2, z2 = tmoe.route(tp, torch.from_numpy(x), t)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    assert i2[5].tolist() == [0, 1, 2]
    assert_scaled(w2, w1, F32_TOL, "weights")
    assert abs(float(z2) - float(z1)) <= F32_TOL * abs(float(z1))


COMBINE_CASES = [
    # (name, E, top_k, capacity_factor, split, dtype)
    ("dropless_bf16", 8, 2, 8.0, 1, "bf16"),
    ("drop_bf16", 8, 2, 0.5, 1, "bf16"),     # capacity 8 of 32*2/8 = 8 avg
    ("drop_top6_bf16", 8, 6, 1.0, 1, "bf16"),
    ("split2_f32", 4, 2, 8.0, 2, "f32"),
    ("split4_drop_f32", 4, 2, 1.0, 4, "f32"),
]


@pytest.mark.parametrize("combine", ["scatter_psum", "gather"])
@pytest.mark.parametrize("case", COMBINE_CASES, ids=lambda c: c[0])
def test_moe_ffn_matches_reference(case, combine):
    name, E, K, cf, sp, dt = case
    dtype = jnp.bfloat16 if dt == "bf16" else jnp.float32
    d, f = 32, 64
    jp, _ = _weights(E, d, f, 2, dtype)
    if sp > 1:
        jp = _split(jp, E, d, f, sp)
    tp = {k: to_torch(v) for k, v in jp.items()}
    rng = np.random.default_rng(3)
    jx = jnp.asarray(rng.standard_normal((2, 16, d)), dtype)
    r, t = _cfgs(num_experts=E, top_k=K, d_expert=f, capacity_factor=cf,
                 expert_split=sp)
    y1, a1 = rmoe.moe_ffn(jp, jx, r, "geglu", combine=combine)
    y2, a2 = tmoe.moe_ffn(tp, to_torch(jx), t, "geglu", combine=combine)
    assert y2.dtype == to_torch(jx).dtype
    assert_scaled(y2, y1, BF16_TOL if dt == "bf16" else F32_TOL, name)
    assert abs(float(a2) - float(a1)) <= F32_TOL * abs(float(a1))
    if "drop" in name.split("_"):
        # the capacity drop is real: some (token, k) pair lost its slot
        _, ids, _ = tmoe.route(tp, to_torch(jx).reshape(32, d), t)
        load = tmoe.expert_load(ids, E)
        assert load.max() > tmoe._capacity(32, t)


def test_valiant_shuffle_dropless_is_permutation_free():
    """Where nothing is dropped the shuffle cannot change the result, so
    the port (its own generator) matches the reference (its own key), as
    ``tests/test_models.py`` assumes of a dropless capacity."""
    jp, tp = _weights(8, 32, 64, 4, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    r, t = _cfgs(num_experts=8, top_k=2, d_expert=64, capacity_factor=16.0,
                 valiant_shuffle=True)
    y1, _ = rmoe.moe_ffn(jp, jnp.asarray(x), r, "swiglu",
                         rng=jax.random.PRNGKey(7))
    g = torch.Generator().manual_seed(11)
    y2, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), t, "swiglu", generator=g)
    assert_scaled(y2, y1, F32_TOL, "shuffled")
    y3, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), t, "swiglu")   # seed 0
    assert_scaled(y3, y1, F32_TOL, "default generator")


def test_shared_ffn_and_expert_load():
    rng = np.random.default_rng(6)
    p = {k: bf16(rng.standard_normal(s) / np.sqrt(s[0]))
         for k, s in {"w_gate": (32, 48), "w_up": (32, 48),
                      "w_down": (48, 32)}.items()}
    jx, tx = bf16(rng.standard_normal((2, 5, 32)))
    want = rmoe.shared_ffn({k: v[0] for k, v in p.items()}, jx, "swiglu")
    got = tmoe.shared_ffn({k: v[1] for k, v in p.items()}, tx, "swiglu")
    assert_scaled(got, want, BF16_TOL, "shared_ffn")
    ids = rng.integers(0, 6, (20, 3))
    want = np.asarray(rmoe.expert_load(jnp.asarray(ids), 6))
    got = tmoe.expert_load(torch.from_numpy(ids), 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# tests/test_moe_split.py, on the port (weights from numpy, not jax.random)
# --------------------------------------------------------------------------

def test_split_is_exact():
    E, d, f = 4, 32, 64
    jp, _ = _weights(E, d, f, 0, jnp.float32)
    p = {k: to_torch(v) for k, v in jp.items()}
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 16, d)).astype(
            np.float32))
    cfg = MoEConfig(num_experts=E, top_k=2, d_expert=f, capacity_factor=8.0)
    y1, _ = tmoe.moe_ffn(p, x, cfg, "swiglu")
    for sp in (2, 4):
        cfg_s = dataclasses.replace(cfg, expert_split=sp)
        ps = {k: to_torch(v) for k, v in _split(jp, E, d, f, sp).items()}
        y2, _ = tmoe.moe_ffn(ps, x, cfg_s, "swiglu")
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_grok_config_split_divides_model_axis():
    from repro_torch.configs.registry import get_config
    cfg = get_config("grok_1_314b")
    assert cfg.moe.expert_split == 2
    assert (cfg.moe.num_experts * cfg.moe.expert_split) % 16 == 0
    assert 300e9 < cfg.param_count() < 330e9


def test_combine_modes_agree():
    E, d, f = 8, 32, 64
    _, p = _weights(E, d, f, 1, jnp.float32)
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, 16, d)).astype(
            np.float32))
    cfg = MoEConfig(num_experts=E, top_k=2, d_expert=f, capacity_factor=4.0)
    y_g, _ = tmoe.moe_ffn(p, x, cfg, "swiglu", combine="gather")
    y_s, _ = tmoe.moe_ffn(p, x, cfg, "swiglu", combine="scatter_psum")
    np.testing.assert_allclose(y_g.numpy(), y_s.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("combine", ["scatter_psum", "gather"])
def test_split_router_of_the_parameters_drops_like_the_reference(combine):
    """With expert_split > 1 ``init_params`` gives the router
    num_experts * sp columns (grok: 16), and ids of num_experts and up
    expand past the E thin experts.  The reference's scatters drop those
    (token, k) pairs; the port drops them too.  Its gather combine reads
    NaN there (``jnp.take`` fills out of range), where the port's reads
    the zero row, so both of the port's combines agree."""
    E, sp, d, f = 4, 2, 32, 64
    jp, _ = _weights(E * sp, d, f // sp, 12, jnp.float32)   # 8 thin experts
    tp = {k: to_torch(v) for k, v in jp.items()}
    rng = np.random.default_rng(13)
    jx = jnp.asarray(rng.standard_normal((2, 16, d)), jnp.float32)
    r, t = _cfgs(num_experts=E, top_k=2, d_expert=f, capacity_factor=8.0,
                 expert_split=sp)
    _, ids, _ = tmoe.route(tp, to_torch(jx).reshape(32, d), t)
    assert int(ids.max()) >= E          # some parents expand past E
    y2, a2 = tmoe.moe_ffn(tp, to_torch(jx), t, "swiglu", combine=combine)
    assert torch.isfinite(y2).all()
    y1, a1 = rmoe.moe_ffn(jp, jx, r, "swiglu", combine="scatter_psum")
    assert_scaled(y2, y1, F32_TOL, combine)
    assert abs(float(a2) - float(a1)) <= F32_TOL * abs(float(a1))
    if combine == "gather":
        yg, _ = rmoe.moe_ffn(jp, jx, r, "swiglu", combine="gather")
        assert np.isnan(np.asarray(yg)).any()
