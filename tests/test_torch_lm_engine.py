"""The port's LM ``Engine`` and ``launch.serve``: the edge semantics of
``tests/test_serve_engine.py`` run on the port, greedy ties, seeded
sampling, in-place caches, and CUDA by default (raising without it,
never falling back to the CPU).  Greedy tokens against the reference's
Engine are in ``test_torch_lm_model*.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as tm
from repro_torch.models import params as tp
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm_engine():
    cfg = get_smoke_config("qwen3_4b")
    params = tp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


# --------------------------------------------------------------------------
# tests/test_serve_engine.py's edges, on the port (generator= for key=)
# --------------------------------------------------------------------------

def test_generate_steps_zero_returns_prompts(lm_engine):
    cfg, params = lm_engine
    eng = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
    prompts = np.array([[1, 2, 3], [4, 5, 6]], dtype=np.int32)
    out = eng.generate(prompts, steps=0)
    np.testing.assert_array_equal(out, prompts)
    # and a (B, 0) prompt with steps=0 is a harmless no-op
    empty = np.zeros((2, 0), dtype=np.int32)
    assert eng.generate(empty, steps=0).shape == (2, 0)
    # steps=0 never samples, so it must not demand a generator either
    sampling = Engine(cfg, params, ServeConfig(max_len=32, temperature=0.9),
                      device="cpu")
    np.testing.assert_array_equal(sampling.generate(prompts, steps=0),
                                  prompts)


def test_generate_empty_prefill_raises(lm_engine):
    cfg, params = lm_engine
    eng = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
    empty = np.zeros((2, 0), dtype=np.int32)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate(empty, steps=4)


def test_generate_temperature_requires_generator(lm_engine):
    """temperature > 0 without a generator never decodes greedily."""
    cfg, params = lm_engine
    eng = Engine(cfg, params, ServeConfig(max_len=32, temperature=0.8),
                 device="cpu")
    prompts = np.array([[1, 2]], dtype=np.int32)
    with pytest.raises(ValueError, match="requires a generator"):
        eng.generate(prompts, steps=2)
    out = eng.generate(prompts, steps=2,
                       generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 4)


def test_generate_greedy_still_works(lm_engine):
    cfg, params = lm_engine
    eng = Engine(cfg, params, ServeConfig(max_len=32), device="cpu")
    prompts = np.array([[1, 2]], dtype=np.int32)
    out = eng.generate(prompts, steps=3)
    assert out.shape == (1, 5)
    np.testing.assert_array_equal(out[:, :2], prompts)


# --------------------------------------------------------------------------
# the port's own
# --------------------------------------------------------------------------

def test_sampling_is_seeded(lm_engine):
    """The same generator seed gives the same tokens; the tokens are not
    the greedy ones (temperature 1.0 over a 512-token vocab)."""
    cfg, params = lm_engine
    eng = Engine(cfg, params, ServeConfig(max_len=32, temperature=1.0),
                 device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 4))
    a = eng.generate(prompts, 10, generator=torch.Generator().manual_seed(5))
    b = eng.generate(prompts, 10, generator=torch.Generator().manual_seed(5))
    c = eng.generate(prompts, 10, generator=torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    greedy = Engine(cfg, params, ServeConfig(max_len=32),
                    device="cpu").generate(prompts, 10)
    assert not np.array_equal(a, greedy)


def test_greedy_takes_the_first_maximum_on_ties(lm_engine, monkeypatch):
    """jnp.argmax returns the first maximum; so does the port's greedy
    pick, on logits with exact ties."""
    cfg, params = lm_engine

    def tied(params, cfg, tokens, caches, pos):
        logits = torch.zeros((tokens.shape[0], 1, cfg.vocab_size))
        logits[:, 0, [7, 300, 11]] = 2.0          # three-way tie
        logits[1, 0, 3] = 2.0                     # row 1: tie earlier
        return logits, caches

    monkeypatch.setattr(tm, "decode_step", tied)
    out = Engine(cfg, params, ServeConfig(max_len=8),
                 device="cpu").generate(np.ones((2, 1), np.int32), 2)
    np.testing.assert_array_equal(out[:, 1:], [[7, 7], [3, 3]])


def test_caches_are_allocated_once_and_written_in_place(lm_engine,
                                                        monkeypatch):
    cfg, params = lm_engine
    calls, ptrs = [], set()
    real_init, real_step = tm.init_cache, tm.decode_step

    def init(*a, **k):
        calls.append(a)
        return real_init(*a, **k)

    def step(params, cfg, tokens, caches, pos):
        logits, out = real_step(params, cfg, tokens, caches, pos)
        assert out is caches
        ptrs.update(t.data_ptr() for t in tp.tree_leaves(out))
        return logits, out

    monkeypatch.setattr(tm, "init_cache", init)
    monkeypatch.setattr(tm, "decode_step", step)
    Engine(cfg, params, ServeConfig(max_len=16), device="cpu").generate(
        np.ones((2, 3), np.int32), 5)
    assert len(calls) == 1
    assert len(ptrs) == len(tp.tree_leaves(real_init(cfg, 2, 16,
                                                      device="cpu")))


def test_launch_serve_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "xlstm_1_3b", "--smoke",
                             "--device", "cpu", "--batch", "2",
                             "--prompt-len", "3", "--gen", "4"])
    assert out.shape == (2, 7)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req0", "req1"]


def test_entry_points_raise_without_cuda(lm_engine, monkeypatch):
    """CUDA by default; without it every LM entry point raises, and the
    CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = lm_engine
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.from_reference(cfg, tp.tree_map(lambda t: t.float().numpy(),
                                           params))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--smoke"])
    assert Engine(cfg, params, device="cpu").device.type == "cpu"
