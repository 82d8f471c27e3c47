"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.  Both are loaded by path and their output is
captured:

* ``quickstart``: the text equals the reference's, character for
  character (the Emu model and the migration counts are bitwise copies).
* ``reorder_study``: the Emu columns equal the reference's; the "this
  CPU" columns are wall clock, so only positive and finite.
* ``autotune_serve``: the text equals the reference's line for line but
  the last column of the table, where the reference prints
  ``allclose(y, A x, atol=1e-6)`` (a float64 check) and the port its
  |A|·|x|-scaled error against float64 ``csr_matvec``, each at most
  ``SCALED_TOL``.
* ``serve_lm``: on the reference's weights (``from_reference``), the
  greedy tokens equal the reference's but at near-ties, by
  ``tests/test_torch_lm_model.py``'s rule; the reference's engine steps
  op by op (under ``jax.jit`` XLA keeps excess precision).
* ``moe_valiant``: on the reference's weights and tokens, and with the
  reference's ``jax.random.permutation(PRNGKey(7), T)`` passed as
  ``perm=``, the routes, loads and drops equal the reference's and the
  text is equal; the outputs within ``BF16_TOL``.
* ``train_lm``: 3 steps at ``--d-model 32 --layers 2 --batch 2 --seq
  16`` from the reference's initial parameters, the reference's loop
  run op by op: loss within ``LOSS_TOL``, gnorm within ``GNORM_RTOL``
  (``tests/test_torch_train_loop.py``'s), lr equal.
* each example that takes ``--device`` raises on ``cuda`` without a GPU.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import model as rm
from repro.models import params as rp
from repro.serve.engine import Engine as RefEngine
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from test_torch_lm_layers import BF16_TOL, assert_scaled
from test_torch_lm_model import assert_logits, f32
from test_torch_train_loop import GNORM_RTOL, LOSS_TOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCALED_TOL = 2e-4
DEVICE_EXAMPLES = ("autotune_serve", "serve_lm", "moe_valiant", "train_lm")


def load(folder: str, name: str):
    """``folder/name.py`` as a fresh module; ``sys.path`` as it was (each
    example puts ``src`` in front of it)."""
    saved = list(sys.path)
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def ref(name):
    return load("examples", name)


def port(name):
    return load("examples_torch", name)


def test_quickstart_text_equal(capsys):
    ref("quickstart").main()
    want = capsys.readouterr().out
    out = port("quickstart").main([])
    got = capsys.readouterr().out
    assert got == want
    assert len(out["rows"]) == 16


def test_reorder_study_emu_columns_equal(capsys):
    ref("reorder_study").main()
    want = capsys.readouterr().out.splitlines()
    out = port("reorder_study").main([])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) and got[0] == want[0]
    assert got[5:] == want[5:]
    for g, w in zip(got[1:5], want[1:5]):
        assert g.split()[:3] == w.split()[:3], (g, w)
    for row in out["rows"]:
        assert np.isfinite(row["cpu_mbs"]) and row["cpu_mbs"] > 0
        assert np.isfinite(row["cpu_gain"]) and row["cpu_gain"] > 0


def test_autotune_serve_text_and_scaled_errors(capsys):
    ref("autotune_serve").main()
    want = capsys.readouterr().out.splitlines()
    out = port("autotune_serve").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    table = range(0, 5)             # the header and the four tenants
    for i in table:
        assert want[i].split()[-1] in ("served-ok", "True", "False")
        assert got[i].rsplit(None, 1)[0] == want[i].rsplit(None, 1)[0], i
    assert got[0].split()[-1] == "scaled-err<=2e-4"
    assert [g for i, g in enumerate(got) if i not in table] == \
        [w for i, w in enumerate(want) if i not in table]
    assert list(out["tenants"]) == ["cop20k_A", "webbase-1M", "audikw_1",
                                    "mixed"]
    for name, t in out["tenants"].items():
        assert 0 <= t["scaled_error"] <= SCALED_TOL and t["ok"], name
    assert out["gate"]["cop20k_A"]["pays"]
    assert not out["gate"]["audikw_1"]["pays"]


def test_serve_lm_tokens_match_reference(capsys, monkeypatch):
    """The reference example's own run, its engine stepping op by op and
    its logits kept; then the port's ``run`` on the same weights, its
    tokens held to the reference's by the near-tie rule of
    ``tests/test_torch_lm_model.py``: a step whose reference top-2 logits
    lie within twice the row's max |port - reference| (the port's logits
    replayed along the reference's tokens) may pick either; past a
    parting there the row is skipped; half the steps must be compared."""
    mod = ref("serve_lm")
    seen = {"logits": []}

    class Recording(RefEngine):
        def __init__(self, cfg, params, serve_cfg):
            super().__init__(cfg, params, serve_cfg)
            seen.update(cfg=cfg, params=params)

            def step(p, tok, caches, pos):
                logits, caches = rm.decode_step(p, cfg, tok, caches, pos)
                seen["logits"].append(f32(logits[:, 0]))
                return logits, caches
            self._decode = step

    monkeypatch.setattr(mod, "Engine", Recording)
    mod.main()
    text = capsys.readouterr().out.splitlines()
    want = np.array([json.loads(line.split(":", 1)[1]) for line in text[1:]],
                    np.int32)
    ex = port("serve_lm")
    cfg = ex.get_smoke_config("qwen3_4b")
    params = tp.from_reference(cfg, jax.tree.map(np.asarray, seen["params"]),
                               device="cpu")
    out = ex.run(cfg, params, "cpu")
    got = out["tokens"]
    assert capsys.readouterr().out.splitlines()[0] == text[0]
    P, steps = 8, 16
    assert got.dtype == np.int32 and got.shape == want.shape == (4, P + steps)
    np.testing.assert_array_equal(got[:, :P], out["prompts"])
    np.testing.assert_array_equal(want[:, :P], out["prompts"])
    pc = tm.init_cache(cfg, 4, 64, device="cpu")
    tol = []
    for t in range(P + steps - 1):
        b, pc = tm.decode_step(params, cfg,
                               torch.from_numpy(want[:, t: t + 1]), pc, t)
        if t >= P - 1:
            a, b = seen["logits"][t], f32(b[:, 0])
            assert_logits(b, a, f"replayed step {t}")
            top2 = np.sort(a, axis=-1)[:, -2:]
            tol.append((top2[:, 1] - top2[:, 0],
                        2 * np.abs(b - a).max(axis=-1)))
    compared = 0
    for row in range(4):
        for i, (gap, moved) in enumerate(tol):
            same = got[row, P + i] == want[row, P + i]
            if gap[row] <= moved[row]:
                if not same:
                    break
                continue
            assert same, (row, i)
            compared += 1
    assert compared >= 4 * steps // 2, compared


def test_moe_valiant_matches_reference(capsys, monkeypatch):
    """The reference example's draws (weights, tokens, its Valiant key
    7) reach the port's ``run``: routes, loads and drops equal, and the
    printout too; the outputs within ``BF16_TOL``."""
    mod = ref("moe_valiant")
    calls = []
    real = mod.moe_ffn

    def recording(params, x, cfg, activation, **kw):
        y = real(params, x, cfg, activation, **kw)
        calls.append((params, x, cfg, kw, y[0]))
        return y
    monkeypatch.setattr(mod, "moe_ffn", recording)
    mod.main()
    want = capsys.readouterr().out
    (params, x, _, _, y0), (_, _, rcfg2, kw, y1) = calls
    assert rcfg2.valiant_shuffle and int(kw["rng"][1]) == 7
    T = x.shape[0] * x.shape[1]
    perm = torch.from_numpy(np.asarray(
        jax.random.permutation(jax.random.PRNGKey(7), T)).astype(np.int64))
    ex = port("moe_valiant")
    cfg = ex.get_smoke_config("deepseek_moe_16b").moe

    def to_t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    out = ex.run(cfg, {k: to_t(v) for k, v in params.items()}, to_t(x),
                 perm, "cpu")
    assert capsys.readouterr().out == want
    _, rids, _ = mod.route(params, x.reshape(-1, x.shape[-1]), calls[0][2])
    np.testing.assert_array_equal(out["ids"].numpy(), np.asarray(rids))
    np.testing.assert_array_equal(
        out["load"], np.asarray(mod.expert_load(rids, cfg.num_experts)))
    assert out["drop"] == (0.0, 0.0)     # the reference's 0.000 / 0.000
    assert_scaled(out["y"][0], f32(y0), BF16_TOL, "plain")
    assert_scaled(out["y"][1], f32(y1), BF16_TOL, "valiant")


def test_train_lm_matches_reference(capsys, monkeypatch, tmp_path):
    """Three steps of each example's loop from the reference's initial
    parameters (``init_params(cfg, PRNGKey(0))``, what its loop draws);
    the reference's loop runs op by op."""
    mod = ref("train_lm")
    seen = {"metrics": []}
    real = mod.train_loop

    def recording(cfg, *args, on_metrics=None, **kw):
        seen["cfg"] = cfg

        def keep(step, m):
            seen["metrics"].append(dict(m))
            on_metrics(step, m)
        with jax.disable_jit():
            return real(cfg, *args, on_metrics=keep, **kw)
    monkeypatch.setattr(mod, "train_loop", recording)
    flags = ["--steps", "3", "--d-model", "32", "--layers", "2",
             "--batch", "2", "--seq", "16"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *flags, "--ckpt",
                                      str(tmp_path / "ref")])
    mod.main()
    want = capsys.readouterr().out.splitlines()
    ex = port("train_lm")
    cfg = ex.model_config(32, 2)
    rparams = rp.init_params(seen["cfg"], jax.random.PRNGKey(0))
    params = tp.from_reference(cfg, jax.tree.map(np.asarray, rparams),
                               device="cpu")
    out = ex.run(cfg, 3, 2, 16, str(tmp_path / "port"), "cpu",
                 params=params)
    got = capsys.readouterr().out.splitlines()
    assert want[0] == f"model: {ex.count_params_config(cfg)/1e6:.1f}M params"
    assert [g.split()[:2] for g in got[:-1]] == \
        [w.split()[:2] for w in want[1:-1]]
    assert len(out["metrics"]) == len(seen["metrics"]) == 3
    for s, (g, w) in enumerate(zip(out["metrics"], seen["metrics"])):
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL, (s, g, w)
        np.testing.assert_allclose(g["gnorm"], w["gnorm"], rtol=GNORM_RTOL)
        assert g["lr"] == w["lr"], s
    assert len(out["step_s"]) == 3 and min(out["step_s"]) > 0


def test_train_lm_main_on_cpu(capsys, tmp_path):
    """``main`` with ``--device cpu``: the reference's flags, its own
    seeded draw, a checkpoint every 50 steps (none in 3)."""
    out = port("train_lm").main([
        "--steps", "3", "--d-model", "32", "--layers", "2", "--batch", "2",
        "--seq", "16", "--ckpt", str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("model: ") and "done; checkpoints in" in text
    assert all(np.isfinite([m["loss"], m["gnorm"]]).all()
               for m in out["metrics"])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", DEVICE_EXAMPLES)
def test_device_examples_raise_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = port(name)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ex.main(argv)


@pytest.mark.parametrize("name", ["quickstart", "reorder_study"])
def test_host_examples_take_no_device(name):
    with pytest.raises(SystemExit):
        port(name).main(["--device", "cpu"])
