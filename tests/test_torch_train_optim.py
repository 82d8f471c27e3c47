"""The port's optimizer, gradient compression and token stream
(``repro_torch.optim``, ``repro_torch.data.synthetic``) against the
reference on the same inputs, drawn with numpy from a seed.  The
reference's ``apply_updates`` runs op by op (``jax.disable_jit``).

Tolerances, from the worst seen:

* ``schedule``: ``lr`` times 2**-23, one ulp of the cosine scaled
  (``jnp.cos`` and ``torch.cos`` may part by an ulp, which ``1 + cos``
  magnifies near the end of the decay; worst seen 9.1e-12 at lr 3e-4;
  most steps are bitwise).
* ``global_norm``: ``NORM_RTOL`` (worst seen 1.3e-6: the two frameworks
  sum in other orders, and the port squares each leaf's norm).
* ``apply_updates`` over 5 steps: bf16 parameters within 1 bf16 ulp, with
  the share of flips counted (worst seen 0); f32 parameters within
  ``P32_RTOL`` (worst seen 2.2e-7, the clip scale and the bias corrections
  differ by an ulp through the norm and ``pow``); ``m`` and ``v`` within
  ``MOMENT_TOL`` of each leaf's max |reference| (worst seen 3.1e-6).
* the int8 compression and the token stream: bitwise.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_smoke_config as ref_smoke
from repro.data import synthetic as rsyn
from repro.optim import adamw as ra
from repro.optim import grad_compress as rgc
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data import synthetic as tsyn
from repro_torch.models import params as tp
from repro_torch.optim import adamw as ta
from repro_torch.optim import grad_compress as tgc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
NORM_RTOL = 1e-5
P32_RTOL = 1e-6
MOMENT_TOL = 1e-5
MAX_FLIP_SHARE = 0.01
SHAPES = {"a": (3, 40, 24), "b": (50,), "c": (17, 33), "d": (2, 5, 6)}
DTYPES = {"a": "bf16", "b": "f32", "c": "bf16", "d": "f32"}


def to_jax(x, dt):
    return jnp.asarray(x, jnp.bfloat16 if dt == "bf16" else jnp.float32)


def to_port(x, dt):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)


def draw_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def port_cfg(ref_cfg):
    return ta.AdamWConfig(**dataclasses.asdict(ref_cfg))


def test_configs_mirror_the_reference():
    assert dataclasses.asdict(ta.AdamWConfig()) == \
        dataclasses.asdict(ra.AdamWConfig())
    assert ta.AdamWState._fields == ra.AdamWState._fields
    assert dataclasses.asdict(tsyn.DataConfig()) == \
        dataclasses.asdict(rsyn.DataConfig())


@pytest.mark.parametrize("ref_cfg", [
    ra.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8),
    ra.AdamWConfig(),
    ra.AdamWConfig(warmup_steps=0, total_steps=5, min_lr_frac=0.0),
], ids=["short", "default", "no_warmup"])
def test_schedule(ref_cfg):
    cfg = port_cfg(ref_cfg)
    steps = range(0, ref_cfg.total_steps + 2,
                  max(1, ref_cfg.total_steps // 64))
    for s in list(steps) + [ref_cfg.total_steps + 1]:
        want = np.float32(ra.schedule(ref_cfg, jnp.int32(s)))
        got = ta.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(got.numpy() - want) <= ref_cfg.lr * 2.0 ** -23, (s, got,
                                                                    want)


def test_global_norm():
    rng = np.random.default_rng(0)
    tree = draw_tree(rng, 0.3)
    want = float(ra.global_norm({k: to_jax(v, DTYPES[k])
                                 for k, v in tree.items()}))
    got = ta.global_norm({k: to_port(v, DTYPES[k]) for k, v in tree.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=NORM_RTOL)


def run_both(steps, ref_cfg, *, grad_scale=0.3, seed=0):
    """``steps`` updates on both sides from the same parameters and
    gradients."""
    rng = np.random.default_rng(seed)
    p0 = draw_tree(rng)
    rp = {k: to_jax(v, DTYPES[k]) for k, v in p0.items()}
    pp_ = {k: to_port(v, DTYPES[k]) for k, v in p0.items()}
    rs, ts = ra.init_state(rp), ta.init_state(pp_)
    cfg = port_cfg(ref_cfg)
    metrics = []
    for _ in range(steps):
        g = draw_tree(rng, grad_scale)
        with jax.disable_jit():
            rp, rs, rm = ra.apply_updates(
                rp, {k: to_jax(v, DTYPES[k]) for k, v in g.items()}, rs,
                ref_cfg)
        pp_, ts, tm = ta.apply_updates(
            pp_, {k: to_port(v, DTYPES[k]) for k, v in g.items()}, ts, cfg)
        metrics.append((rm, tm))
    return (rp, rs), (pp_, ts), metrics


@pytest.mark.parametrize("grad_scale", [0.3, 1e-3],
                         ids=["clipped", "unclipped"])
def test_apply_updates_five_steps(grad_scale):
    ref_cfg = ra.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    (rp, rs), (pp_, ts), metrics = run_both(5, ref_cfg,
                                            grad_scale=grad_scale)
    for rm, tm in metrics:
        np.testing.assert_allclose(float(tm["gnorm"]), float(rm["gnorm"]),
                                   rtol=NORM_RTOL)
        assert float(tm["lr"]) == float(rm["lr"])
    assert int(ts.step) == int(rs.step) == 5 and ts.step.dtype == torch.int32
    flips = total = 0
    for k in SHAPES:
        want = np.asarray(rp[k], np.float32)
        got = pp_[k].float().numpy()
        assert str(pp_[k].dtype) == "torch." + np.asarray(rp[k]).dtype.name
        if DTYPES[k] == "bf16":
            # one bf16 ulp: 2**-7 of the power of two at or below |x|
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert np.all(np.abs(got - want) <= ulp), k
            flips += int(np.sum(got != want))
            total += want.size
        else:
            np.testing.assert_allclose(got, want, rtol=P32_RTOL, err_msg=k)
        for name, a, b in (("m", rs.m[k], ts.m[k]), ("v", rs.v[k], ts.v[k])):
            a = np.asarray(a)
            assert b.dtype == torch.float32
            err = np.abs(b.numpy() - a).max() / np.abs(a).max()
            assert err <= MOMENT_TOL, (k, name, err)
    print(f"bf16 parameters: {flips} of {total} one ulp off the reference")
    assert flips <= MAX_FLIP_SHARE * total


def test_apply_updates_in_place_and_sliced_bitwise(monkeypatch):
    """The update writes the given tensors; blocks of rows as small as one
    row give bitwise the whole-leaf update."""
    rng = np.random.default_rng(3)
    p0 = draw_tree(rng)
    cfg = ta.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    runs = []
    for chunk in (1, 40, 10 ** 9):
        monkeypatch.setattr(ta, "CHUNK_ELEMS", chunk)
        params = {k: to_port(v, DTYPES[k]) for k, v in p0.items()}
        ptrs = {k: t.data_ptr() for k, t in params.items()}
        state = ta.init_state(params)
        grng = np.random.default_rng(4)
        for _ in range(3):
            g = {k: to_port(v, DTYPES[k])
                 for k, v in draw_tree(grng, 0.3).items()}
            params, state, _ = ta.apply_updates(params, g, state, cfg)
        assert {k: t.data_ptr() for k, t in params.items()} == ptrs
        runs.append((params, state))
    for params, state in runs[:2]:
        for a, b in zip(tp.tree_leaves((params, state)),
                        tp.tree_leaves(runs[2])):
            assert torch.equal(a, b)


def test_state_init_and_abstract():
    params = {k: to_port(v, DTYPES[k])
              for k, v in draw_tree(np.random.default_rng(0)).items()}
    s = ta.init_state(params)
    a = ta.abstract_state(params)
    for st in (s, a):
        assert st.step.dtype == torch.int32 and st.step.shape == ()
        for m, p in zip(tp.tree_leaves((st.m, st.v)),
                        tp.tree_leaves((params, params))):
            assert m.shape == p.shape and m.dtype == torch.float32
    assert a.step.device.type == "meta" and s.step.device.type == "cpu"
    assert all(float(t.abs().max()) == 0 for t in tp.tree_leaves(s))


# --------------------------------------------------------------------------
# int8 gradient compression
# --------------------------------------------------------------------------

def grad_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((64, 64)).astype(np.float32),
            "b": {"c": (rng.standard_normal(33) * 1e-3).astype(np.float32),
                  "d": rng.standard_normal((4, 8)).astype(np.float32)}}
    # exact ties at half a quantum, where round-half-to-even decides
    tree["a"][0, :4] = [127.0, 0.5, 1.5, -2.5]
    return tree


def to_tree(tree, fn):
    return {k: to_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def test_quantize_dequantize_bitwise():
    x = grad_tree(0)["a"]
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    rq, rs = rgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    np.testing.assert_array_equal(
        tgc.dequantize_int8(q, s).numpy(),
        np.asarray(rgc.dequantize_int8(rq, rs)))


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_tree_bitwise(with_residual):
    grads = grad_tree(1)
    resid = to_tree(grad_tree(2), lambda a: a * 1e-3) if with_residual \
        else None
    want = rgc.compress_tree(
        to_tree(grads, lambda a: jnp.asarray(a, jnp.bfloat16)),
        None if resid is None else to_tree(resid, jnp.asarray))
    got = tgc.compress_tree(
        to_tree(grads, lambda a: torch.from_numpy(a).to(torch.bfloat16)),
        None if resid is None else to_tree(resid, torch.from_numpy))
    for w_tree, g_tree in zip(want, got):
        w_leaves = jax.tree.leaves(w_tree)
        g_leaves = tp.tree_leaves(g_tree)
        assert len(w_leaves) == len(g_leaves) == 3
        for w, g in zip(w_leaves, g_leaves):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype
            assert g.numpy().tobytes() == w.tobytes()


_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.optim import grad_compress as gc
    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    rng = np.random.default_rng(10 + rank)
    grads = {"a": torch.from_numpy(rng.standard_normal((16, 8))
                                   .astype(np.float32) * (1 + rank)),
             "b": torch.from_numpy(rng.standard_normal(5)
                                   .astype(np.float32))}
    deq, resid = gc.psum_compressed(grads, None)
    np.savez(out, **{f"g_{k}": v.numpy() for k, v in grads.items()},
             **{f"deq_{k}": v.numpy() for k, v in deq.items()},
             **{f"res_{k}": v.numpy() for k, v in resid.items()})
    dist.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_psum_compressed_two_rank_gloo(tmp_path):
    """Two spawned ranks on a gloo CPU group: each rank's mean gradients
    equal the reference's formula (int8 sum as int32, MAX of the scales,
    divided by 2) applied to both ranks' ``compress_tree``, bitwise, and
    each keeps its own residual."""
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), port,
         str(tmp_path / f"r{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    outs = [np.load(tmp_path / f"r{r}.npz") for r in range(2)]
    comp = [rgc.compress_tree({k: jnp.asarray(o[f"g_{k}"]) for k in "ab"},
                              None) for o in outs]
    for k in "ab":
        summed = sum(np.asarray(c[0][k]).astype(np.int32) for c in comp)
        smax = np.maximum(*(np.asarray(c[1][k]) for c in comp))
        want = (summed.astype(np.float32) * smax) / np.float32(2)
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[f"deq_{k}"], want)
            np.testing.assert_array_equal(o[f"res_{k}"],
                                          np.asarray(comp[r][2][k]))


# --------------------------------------------------------------------------
# the token stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_4b", "musicgen_medium",
                                  "paligemma_3b"])
def test_token_stream_bitwise(arch):
    data = dict(seed=3, batch=2, seq_len=24)
    ref = rsyn.TokenStream(ref_smoke(arch), rsyn.DataConfig(**data))
    port = tsyn.TokenStream(get_smoke_config(arch), tsyn.DataConfig(**data))
    it = iter(port)
    for step in (0, 1, 2, 9):
        want = ref.batch_at(step)
        got = port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), (step, k)
        if step < 3:
            nxt = next(it)
            assert all(np.array_equal(nxt[k], got[k]) for k in got)
