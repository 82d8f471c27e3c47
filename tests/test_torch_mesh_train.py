"""Sharded training and serving (``repro_torch.train.loop`` on a
distributed mesh) on gloo CPU ranks, against the port's one-device step
(which ``test_torch_train_loop.py`` holds to the reference).

Two multi-rank runs (``tests/torch_mesh_ranks.py``), each rank its own
process: four ranks on (2, 2) and two ranks on (1, 2) and (2, 1).  In
each, ``STEPS`` steps of every case from the same seeded weights and the
same ``TokenStream`` batches, then:

* loss, ``ce`` and ``aux`` within ``LOSS_TOL``, ``gnorm`` within
  ``GNORM_RTOL``, ``lr`` bitwise, equal on every rank;
* the gathered parameters within ``PARAM_TOL`` lr a step plus one bf16
  ulp, at most ``MAX_MOVED`` of them more than an ulp apart (all four
  ``test_torch_train_loop.py``'s tolerances); m within ``M_TOL`` and v
  within ``V_TOL`` of their leaf's largest magnitude after the first
  step (``chip_smoke.py``'s card-against-CPU bounds for one step, from
  ``test_torch_train_grads.py``'s 0.06 on a gradient: after more steps
  Adam's parameters part by up to 2 lr where a gradient is near zero,
  and m and v follow the parted gradients, not the rounding);
* each rank's shard shapes of the parameters and m equal the shard
  shapes of the reference's ``param_specs`` on the same mesh.

The MoE archs, and xLSTM on (2, 1), train on float32 weights: a
data-parallel step sums each batch shard's gradient, and in bf16 each
share is rounded before the sum, which flips MoE routes at the second
step (as in the LM tests) and, through xLSTM's growing second-step
norm, moved its ``gnorm`` by 0.995% in bf16.
Capacity over "data" needs E not to divide the model axis, so grok runs
it with 3 experts; with ``expert_split`` 2 its E is even and the layer
runs expert-parallel, as the published grok (16 thin experts on a
16-wide axis) does.  deepseek with 16 experts stores its expert weights
split by expert over "model" (E divides 16, as the published 64 do), so
each rank gathers its own experts only.

The same four ranks count the bytes of every collective they send in a
train, prefill and decode step, held to the dry run's account.
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh, NamedSharding

from repro.models import params as rparams
from repro.train import checkpoint as rckpt
from repro.optim import adamw as ra
from repro_torch.models import params as tp
from repro_torch.train import loop as tloop
from test_torch_train_loop import LOSS_TOL, GNORM_RTOL, PARAM_TOL, MAX_MOVED
import torch_mesh_ranks as tr

torch.set_num_threads(1)

M_TOL, V_TOL = 0.06, 0.12
QWEN_CASES = [dict(arch="qwen3_4b", fsdp=f, accum=a, f32=False)
              for f in (True, False) for a in (1, 2)]
FOUR = [("train", dict(c, model=2)) for c in QWEN_CASES] + [
    ("train", dict(arch="deepseek_moe_16b", fsdp=True, accum=1, f32=True,
                   model=2)),
    ("train", dict(arch="grok_1_314b", fsdp=True, accum=1, f32=True,
                   model=2, moe=dict(expert_split=2))),
    ("train", dict(arch="grok_1_314b", fsdp=True, accum=2, f32=True,
                   model=2, moe=dict(num_experts=3))),
    ("train", dict(arch="deepseek_moe_16b", fsdp=True, accum=1, f32=True,
                   model=2, moe=dict(num_experts=16))),
    ("serve", dict(arch="qwen3_4b", fsdp=True, model=2, batch=4,
                   max_len=8)),
]
#: One train step (2 micro-batches), one prefill and one decode step,
#: (seq_len, batch) each, whose collectives are counted on every rank.
COUNT_SHAPES = {"train": (16, 4), "prefill": (16, 4), "decode": (8, 4)}
COUNTED = [("qwen3_4b", {}), ("deepseek_moe_16b", {}),
           ("deepseek_moe_16b", dict(num_experts=16)),
           ("grok_1_314b", dict(num_experts=3)), ("recurrentgemma_2b", {})]
FOUR += [("count", dict(arch=a, moe=m, fsdp=True, accum=2, model=2,
                        shapes=COUNT_SHAPES)) for a, m in COUNTED]
OTHERS = [("gemma_7b", 1), ("qwen25_32b", 2), ("command_r_plus_104b", 1),
          ("xlstm_1_3b", 1), ("recurrentgemma_2b", 1),
          ("musicgen_medium", 2), ("paligemma_3b", 1),
          ("deepseek_moe_16b", 1), ("grok_1_314b", 2)]
F32_ARCHS = ("xlstm_1_3b", "deepseek_moe_16b", "grok_1_314b")
TWO = [("train", dict(c, model=m)) for c in QWEN_CASES for m in (1, 2)] + [
    ("train", dict(arch=a, fsdp=True, accum=1, model=m, f32=a in F32_ARCHS))
    for a, m in OTHERS] + [
    ("serve", dict(arch=a, fsdp=True, model=2, batch=2, max_len=8))
    for a in ("qwen3_4b", "xlstm_1_3b", "recurrentgemma_2b")]
SAVED = dict(arch="qwen3_4b", fsdp=True, model=2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    save = ("save", dict(SAVED, dir=str(tmp / "ckpt")))
    res = tr.run_ranks(4, tr.all_cases, (FOUR + [save],), tmp / "run")
    return res, str(tmp / "ckpt")


@pytest.fixture(scope="module")
def two(four, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    extra = [("resume", dict(SAVED, dir=four[1])),
             ("launcher", dict(argv=[
                 "--arch", "qwen3_4b", "--smoke", "--device", "cpu",
                 "--steps", "2", "--batch", "4", "--seq", "16",
                 "--ckpt", str(tmp / "launch")]))]
    return tr.run_ranks(2, tr.all_cases, (TWO + extra,), tmp / "run")


_ONE = {}


def one_device(case, steps=tr.STEPS):
    """The port's one-device run of ``case`` (cached)."""
    key = (steps,) + tuple(sorted((k, str(v)) for k, v in case.items()
                                  if k not in ("model", "dir")))
    if key not in _ONE:
        cfg = tr.smoke_cfg(case["arch"], **case.get("moe", {}))
        run = tloop.RunConfig(fsdp=case["fsdp"], remat=True,
                              grad_accum=case.get("accum", 1))
        _ONE[key] = tr.one_device_train(cfg, run, case.get("f32", False),
                                        steps)
    return _ONE[key]


def assert_metrics(got, want, what):
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), what
        for k in ("loss", "ce", "aux"):
            assert abs(g[k] - w[k]) <= LOSS_TOL, (what, s, k, g[k], w[k])
        assert g["lr"] == w["lr"], (what, s)
        np.testing.assert_allclose(g["gnorm"], w["gnorm"], rtol=GNORM_RTOL,
                                   err_msg=f"{what} step {s}")


def assert_params(got, want, steps, what):
    moved = total = 0
    for g, w in zip(got, want):
        w = w.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= PARAM_TOL * tr.LR * steps + ulp), what
        moved += int(np.sum(np.abs(g - w) > ulp))
        total += w.size
    assert moved <= MAX_MOVED * total, (what, moved, total)


def assert_moments(got, want, tol, what):
    for g, w in zip(got, want):
        w = w.float().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, what


def ref_shard_shapes(case, mesh_shape):
    """The shard shapes of the reference's ``param_specs`` on an abstract
    mesh of ``mesh_shape``, in the port's leaf order."""
    from repro.configs.registry import get_smoke_config
    import dataclasses
    cfg = get_smoke_config(case["arch"])
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    specs = rparams.param_specs(cfg, fsdp=case["fsdp"])
    shapes = rparams.abstract_params(cfg)
    return [NamedSharding(mesh, s).shard_shape(a.shape) for s, a in zip(
        jax.tree.leaves(specs), jax.tree.leaves(shapes))]


def check_train(results, items):
    for i, (kind, case) in enumerate(items):
        if kind != "train":
            continue
        what = str(case)
        params, _, metrics, (m1, v1) = one_device(case)
        for r in results:
            assert_metrics(r[i]["metrics"], metrics, what)
            want = ref_shard_shapes(case, r[i]["mesh"])
            assert r[i]["shapes"] == want, what
            assert r[i]["m_shapes"] == want, what
        gp, gm, gv = results[0][i]["whole"]
        assert_params(gp, tp.tree_leaves(params), tr.STEPS, what)
        assert_moments(gm, tp.tree_leaves(m1), M_TOL, what)
        assert_moments(gv, tp.tree_leaves(v1), V_TOL, what)


def test_four_ranks_train_as_one_device(four):
    check_train(four[0], FOUR)


def test_two_ranks_train_as_one_device(two):
    check_train(two, TWO)


def test_every_arch_trains_on_two_ranks():
    archs = {c["arch"] for kind, c in TWO if kind == "train"}
    assert len(archs) == 10


def one_device_serve(case):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as tm
    cfg = tr.smoke_cfg(case["arch"])
    mesh = make_host_mesh(device="cpu")
    B = case["batch"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 6))
    params = tr.init_params(cfg, False)
    _, for_batch, _ = tloop.make_prefill_step(cfg, mesh, B)
    prefill = for_batch({"tokens": toks})(params, {"tokens": toks})
    serve_step, _, _ = tloop.make_decode_step(cfg, mesh, B)
    caches = tm.init_cache(cfg, B, case["max_len"], device="cpu")
    out = []
    for t in range(toks.shape[1]):
        lg, caches = serve_step(params, torch.from_numpy(toks[:, t: t + 1]),
                                caches, t)
        out.append(lg.float().numpy())
    return prefill.float().numpy(), out


#: Sharded logits against one device's: the decode attention's sums over
#: positions split over "model" add in another order (float32), which
#: can move a bf16 rounding downstream by an ulp.
LOGIT_TOL = 2e-2


def check_serve(results, items):
    from repro.configs.registry import get_smoke_config
    from repro.train import loop as rloop
    for i, (kind, case) in enumerate(items):
        if kind != "serve":
            continue
        prefill, decode = one_device_serve(case)
        scale = float(np.abs(prefill).max())
        for r in results:
            np.testing.assert_allclose(r[i]["prefill"], prefill,
                                       atol=LOGIT_TOL * scale, rtol=0)
            for g, w in zip(r[i]["decode"], decode):
                np.testing.assert_allclose(g, w, atol=LOGIT_TOL * scale,
                                           rtol=0)
        # each rank's cache shards: the reference's cache_specs' shapes
        cfg = get_smoke_config(case["arch"])
        from repro.models import model as rmodel
        mesh = AbstractMesh((4 // case["model"] if len(results) == 4 else
                             2 // case["model"], case["model"]),
                            ("data", "model"))
        specs = rloop.cache_specs(cfg, mesh, case["batch"])
        shapes = rmodel.abstract_cache(cfg, case["batch"], case["max_len"])
        want = [NamedSharding(mesh, s).shard_shape(a.shape) for s, a in zip(
            jax.tree.leaves(specs), jax.tree.leaves(shapes))]
        for r in results:
            assert r[i]["cache_shapes"] == want, case


def test_four_ranks_serve_as_one_device(four):
    check_serve(four[0], FOUR)


def test_two_ranks_serve_as_one_device(two):
    check_serve(two, TWO)


@pytest.mark.parametrize("arch,moe", COUNTED,
                         ids=[a + "".join(f"-{k}{v}" for k, v in m.items())
                              for a, m in COUNTED])
def test_collectives_are_the_dry_runs(four, arch, moe):
    """The output bytes of every all-gather, reduce-scatter and
    all-reduce that a rank sends in a (2, 2) train step, prefill and
    decode step equal ``dryrun.account``'s ``collectives`` for the same
    config, shape, mesh and ``RunConfig``: dense with tensor parallelism
    and qk-norm; MoE expert parallel with the expert weights stored split
    inside each expert (gathered whole) and stored split by expert (kept
    as this rank's experts); capacity over "data"; recurrent decode
    states over "model"."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.config import ShapeConfig
    i, case = next((i, c) for i, (kind, c) in enumerate(FOUR)
                   if kind == "count" and c["arch"] == arch and
                   c["moe"] == moe)
    cfg = tr.smoke_cfg(arch, **moe)
    mesh = Mesh(("data", "model"), (2, 2), ())
    for kind, (S, B) in case["shapes"].items():
        run = tloop.RunConfig(fsdp=case["fsdp"], remat=True,
                              grad_accum=case["accum"] if kind == "train"
                              else 1)
        want = dryrun.account(cfg, ShapeConfig(kind, S, B, kind), mesh,
                              run)["collectives"]
        for r in four[0]:
            assert r[i][kind] == want, (kind, r[i][kind], want)


def test_checkpoint_on_four_ranks_resumes_on_two(four, two):
    """Saved by (2, 2) after step 0, ``shrink_mesh`` to (1, 2) on a world
    of two, ``resume`` re-shards and step 1 runs: the uninterrupted
    sharded run, the resumed step and the parameters after it as the
    one-device run's."""
    params, _, metrics, _ = one_device(dict(SAVED, accum=1, f32=False))
    for r in four[0]:
        assert_metrics(r[-1]["metrics"], metrics, "saving run")
    res = [r[len(TWO)] for r in two]
    for r in res:
        assert r["step"] == 1 and r["world"] == 2
        assert r["mesh"] == {"data": 1, "model": 2}
        assert_metrics(r["metrics"], metrics[1:], "resumed")
    assert res[0]["shapes"] == ref_shard_shapes(SAVED, {"data": 1,
                                                        "model": 2})
    assert_params(res[0]["whole"], tp.tree_leaves(params), tr.STEPS,
                  "resumed")


def test_sharded_checkpoint_restores_in_the_reference(four):
    """``repro.train.checkpoint.restore`` reads what the sharded ranks
    wrote after step 0: whole arrays, equal to the one-device run's
    after one step within the training tolerances."""
    from repro.configs.registry import get_smoke_config
    cfg = get_smoke_config("qwen3_4b")
    abstract = {"params": rparams.abstract_params(cfg)}
    abstract["opt"] = ra.abstract_state(abstract["params"])
    assert rckpt.latest_step(four[1]) == 1
    state, step = rckpt.restore(four[1], 1, abstract)
    assert step == 1 and int(state["opt"].step) == 1
    params, _, _, _ = one_device(dict(SAVED, accum=1, f32=False), steps=1)
    assert_params([np.asarray(x, np.float32) for x in
                   jax.tree.leaves(state["params"])],
                  tp.tree_leaves(params), 1, "reference restore")


def test_sharded_checkpoint_holds_the_whole_arrays(four):
    """The file the (2, 2) ranks wrote, a block at a time
    (``torch_mesh_ranks.CKPT_BLOCK`` bytes), holds every leaf of the
    params and the Adam state whole, bitwise as gathered from the shards
    (bf16 widened to float32), under the manifest's names, shapes and
    dtypes."""
    import json
    import os
    path = os.path.join(four[1], "step_000001")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    saved = four[0][0][-1]["saved"]
    assert len(manifest["names"]) == len(saved)
    with np.load(os.path.join(path, "host_000.npz")) as data:
        for name, shape, dtype, want in zip(
                manifest["names"], manifest["shapes"], manifest["dtypes"],
                saved):
            got = data[name]
            assert list(got.shape) == shape and str(got.dtype) == dtype
            np.testing.assert_array_equal(got.astype(np.float32), want,
                                          err_msg=name)


def test_launcher_on_two_ranks(two):
    """``launch/train.py --smoke --device cpu --steps 2`` with the world's
    process group up: one (1, 2) mesh, rank 0 prints, both finish at
    step 2 with the same finite loss."""
    res = [r[len(TWO) + 1] for r in two]
    assert all(r["step"] == 2 for r in res)
    assert res[0]["metrics"] == res[1]["metrics"]
    assert np.isfinite(res[0]["metrics"]["loss"])
    assert "training complete" in res[0]["stdout"]
    assert res[1]["stdout"] == ""
