"""The port's checkpoints, elastic restart and training launcher
(``repro_torch.train.checkpoint``, ``train.elastic``,
``launch.train``): ``tests/test_fault_tolerance.py`` on the port, and
checkpoints crossing between the packages bitwise, both ways.

The restart test holds the resumed loss to the uninterrupted run's at
``rtol=1e-5``, the reference test's own tolerance (seen: bitwise).
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adamw as ra
from repro.train import checkpoint as rckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.synthetic import DataConfig, TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import params as tp
from repro_torch.optim import adamw as ta
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import elastic
from repro_torch.train.loop import RunConfig, train_loop
from test_torch_lm_model import ref_params

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = get_smoke_config("qwen3_4b")
    stream = TokenStream(cfg, DataConfig(seed=0, batch=4, seq_len=16))
    return cfg, stream, tmp_path_factory.mktemp("ckpt")


def fresh(cfg, seed=0):
    params = tp.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    return params, ta.init_state(params)


def stepped_state(cfg):
    """Parameters and a state with nonzero moments and step 1."""
    params, opt = fresh(cfg)
    grads = tp.tree_map(lambda p: torch.full_like(p, 0.5), params)
    return ta.apply_updates(params, grads, opt, ta.AdamWConfig())[:2]


def assert_trees_equal(a, b):
    la, lb = tp.tree_leaves(a), tp.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, setup):
        cfg, _, tmp = setup
        params, opt = stepped_state(cfg)
        path = ckpt.save(str(tmp / "a"), params, opt, 7, blocking=True)
        assert os.path.isdir(path)
        like = {"params": params, "opt": opt}
        state, step = ckpt.restore(str(tmp / "a"), 7, like, device="cpu")
        assert step == 7
        assert_trees_equal(state, like)
        assert isinstance(state["opt"], ta.AdamWState)
        # into the abstract tree (meta tensors), as resume does
        abstract = {"params": tp.abstract_params(cfg)}
        abstract["opt"] = ta.abstract_state(abstract["params"])
        state, _ = ckpt.restore(str(tmp / "a"), 7, abstract, device="cpu")
        assert_trees_equal(state, like)

    def test_restore_takes_shardings_by_position(self, setup):
        """``shardings`` is ``restore``'s fourth positional parameter, as
        in the reference (whose ``elastic.resume`` passes it so): ``None``
        there restores bitwise as the keyword call, and a sharding tree
        binds to ``shardings`` with ``device`` left at its default."""
        import inspect
        cfg, _, tmp = setup
        params, opt = stepped_state(cfg)
        ckpt.save(str(tmp / "pos"), params, opt, 4, blocking=True)
        like = {"params": params, "opt": opt}
        by_kw, step_kw = ckpt.restore(str(tmp / "pos"), 4, like,
                                      shardings=None, device="cpu")
        by_pos, step_pos = ckpt.restore(str(tmp / "pos"), 4, like, None,
                                        device="cpu")
        assert step_pos == step_kw == 4
        assert_trees_equal(by_pos, by_kw)
        assert_trees_equal(by_pos, like)
        shardings = tp.tree_map(lambda p: object(), like)
        bound = inspect.signature(ckpt.restore).bind(
            str(tmp / "pos"), 4, like, shardings)
        assert bound.arguments["shardings"] is shardings
        assert "device" not in bound.arguments
        assert list(inspect.signature(rckpt.restore).parameters) == \
            list(inspect.signature(ckpt.restore).parameters)[:4]

    def test_latest_step(self, setup):
        cfg, _, tmp = setup
        params, opt = fresh(cfg)
        assert ckpt.latest_step(str(tmp / "b")) is None
        ckpt.save(str(tmp / "b"), params, opt, 3, blocking=True)
        ckpt.save(str(tmp / "b"), params, opt, 9, blocking=True)
        assert ckpt.latest_step(str(tmp / "b")) == 9

    def test_atomicity_no_tmp_left(self, setup):
        cfg, _, tmp = setup
        params, opt = fresh(cfg)
        ckpt.save(str(tmp / "c"), params, opt, 1)
        ckpt.wait_for_writes()
        assert os.listdir(tmp / "c") == ["step_000001"]
        assert sorted(os.listdir(tmp / "c" / "step_000001")) == \
            ["host_000.npz", "manifest.json"]

    def test_structure_mismatch_raises(self, setup):
        cfg, _, tmp = setup
        params, opt = fresh(cfg)
        ckpt.save(str(tmp / "m"), params, opt, 1, blocking=True)
        other = dict(params)
        del other["final_norm"]
        with pytest.raises(ValueError, match="structure mismatch"):
            ckpt.restore(str(tmp / "m"), 1, {"params": other, "opt": opt},
                         device="cpu")


def test_leaf_names_are_jax_key_paths(setup):
    """The names each leaf is saved under are the key paths
    ``jax.tree_util`` prints for the reference's tree: 43 on the smoke
    qwen3."""
    cfg, _, _ = setup
    params, opt = fresh(cfg)
    rparams = ref_params("qwen3_4b")
    want, _, _ = rckpt._flatten_with_names(
        {"params": rparams, "opt": ra.init_state(rparams)})
    got = ckpt.leaf_names({"params": params, "opt": opt})
    assert got == want and len(got) == 43
    for name in ("['opt']/.step", "['opt']/.m/['embed']",
                 "['params']/['embed']"):
        assert name in got


def assert_same_leaves(ref_leaves, port_leaves):
    """Equal dtypes and bitwise equal values (bf16 compared through
    float32, which holds each bf16 value exactly)."""
    assert len(ref_leaves) == len(port_leaves)
    for w, g in zip(ref_leaves, port_leaves):
        w = np.asarray(w)
        assert str(g.dtype) == "torch." + w.dtype.name
        if w.dtype.name == "bfloat16":
            w, g = w.astype(np.float32), g.float()
        assert w.tobytes() == g.numpy().tobytes()


def test_reference_checkpoint_restores_in_the_port(setup):
    cfg, _, tmp = setup
    rparams = ref_params("qwen3_4b")
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), rparams)
    rparams, ropt, _ = ra.apply_updates(rparams, grads,
                                        ra.init_state(rparams),
                                        ra.AdamWConfig())
    rckpt.save(str(tmp / "ref"), rparams, ropt, 5, blocking=True)
    params, opt = fresh(cfg)
    state, step = ckpt.restore(str(tmp / "ref"), 5,
                               {"params": params, "opt": opt}, device="cpu")
    assert step == 5 and int(state["opt"].step) == 1
    assert_same_leaves(jax.tree.leaves({"params": rparams, "opt": ropt}),
                       tp.tree_leaves(state))


def test_port_checkpoint_restores_in_the_reference(setup):
    cfg, _, tmp = setup
    params, opt = stepped_state(cfg)
    ckpt.save(str(tmp / "port"), params, opt, 6, blocking=True)
    rparams = ref_params("qwen3_4b")
    like = {"params": rparams, "opt": ra.init_state(rparams)}
    state, step = rckpt.restore(str(tmp / "port"), 6, like)
    assert step == 6
    assert_same_leaves(jax.tree.leaves(state),
                       tp.tree_leaves({"params": params, "opt": opt}))


class TestElasticRestart:
    def test_restart_continues_loss_curve(self, setup):
        """Train 5 steps with a checkpoint every 2, restart from the last
        (step 4): step 4's loss matches (deterministic stream + restored
        state)."""
        cfg, stream, tmp = setup
        run = RunConfig(fsdp=False, remat=False, donate=False)
        mesh = make_host_mesh(device="cpu")
        losses_a = {}
        train_loop(cfg, ta.AdamWConfig(lr=1e-3), mesh, stream, 5, run,
                   checkpoint_dir=str(tmp / "d"), checkpoint_every=2,
                   on_metrics=lambda s, m: losses_a.__setitem__(s, m["loss"]))
        ckpt.wait_for_writes()
        params, opt, step = elastic.resume(cfg, ta.AdamWConfig(lr=1e-3),
                                           str(tmp / "d"), mesh, run)
        assert step == 4          # saved after steps 2 and 4
        assert int(opt.step) == 4
        losses_b = {}
        train_loop(cfg, ta.AdamWConfig(lr=1e-3), mesh, stream, 5, run,
                   start_step=step, params=params, opt_state=opt,
                   on_metrics=lambda s, m: losses_b.__setitem__(s, m["loss"]))
        assert sorted(losses_b) == [4]
        np.testing.assert_allclose(losses_a[4], losses_b[4], rtol=1e-5)

    def test_restart_with_donation_and_a_held_back_writer(
            self, setup, monkeypatch):
        """With ``donate`` the step updates the buffers in place, so the
        checkpoint must be a copy taken at save time: the writer is held
        back until the run has taken two more steps, and the restart from
        step 4 still continues the curve (steps 4 and 5)."""
        cfg, stream, tmp = setup
        run = RunConfig(fsdp=False, remat=False, donate=True)
        mesh = make_host_mesh(device="cpu")
        release = threading.Event()
        savez = np.savez

        def held_savez(*args, **kw):
            release.wait(timeout=120)
            return savez(*args, **kw)
        monkeypatch.setattr(np, "savez", held_savez)
        losses_a, losses_b = {}, {}
        params, opt = fresh(cfg)
        try:
            _, end, _ = train_loop(
                cfg, ta.AdamWConfig(lr=1e-3), mesh, stream, 6, run,
                checkpoint_dir=str(tmp / "h"), checkpoint_every=4,
                params=params, opt_state=opt,
                on_metrics=lambda s, m: losses_a.__setitem__(s, m["loss"]))
        finally:
            release.set()
            ckpt.wait_for_writes()
        assert int(end.step) == 6 and end.m is opt.m    # donated: in place
        params, opt, step = elastic.resume(cfg, ta.AdamWConfig(lr=1e-3),
                                           str(tmp / "h"), mesh, run)
        assert step == 4 and int(opt.step) == 4
        train_loop(cfg, ta.AdamWConfig(lr=1e-3), mesh, stream, 6, run,
                   start_step=step, params=params, opt_state=opt,
                   on_metrics=lambda s, m: losses_b.__setitem__(s, m["loss"]))
        assert sorted(losses_b) == [4, 5]
        for s in (4, 5):
            np.testing.assert_allclose(losses_a[s], losses_b[s], rtol=1e-5)

    def test_shrink_mesh_preserves_tp(self):
        devs = [CPU] * 5
        m = elastic.shrink_mesh(devs[:4], model_parallel=1)
        assert m.shape == {"data": 4, "model": 1}
        m = elastic.shrink_mesh(devs, model_parallel=2)
        assert m.shape == {"data": 2, "model": 2} and len(m.devices) == 4
        with pytest.raises(RuntimeError, match="cannot keep TP=2"):
            elastic.shrink_mesh(devs[:1], model_parallel=2)

    def test_resume_on_a_shrunk_mesh(self, setup):
        """The elastic path onto one surviving device; a survivor mesh of
        more than one device without a process group over them raises
        (``tests/test_torch_mesh_train.py`` resumes on such a group)."""
        cfg, stream, tmp = setup
        run = RunConfig(fsdp=False, remat=False, donate=False)
        mesh = make_host_mesh(device="cpu")
        train_loop(cfg, ta.AdamWConfig(), mesh, stream, 2, run,
                   checkpoint_dir=str(tmp / "e"), checkpoint_every=2)
        ckpt.wait_for_writes()
        mesh2 = elastic.shrink_mesh([CPU], model_parallel=1)
        params, opt, step = elastic.resume(cfg, ta.AdamWConfig(),
                                           str(tmp / "e"), mesh2, run)
        _, _, metrics = train_loop(cfg, ta.AdamWConfig(), mesh2, stream, 3,
                                   run, start_step=step, params=params,
                                   opt_state=opt)
        assert np.isfinite(metrics["loss"])
        with pytest.raises(RuntimeError, match="without a process group"):
            elastic.resume(cfg, ta.AdamWConfig(), str(tmp / "e"),
                           elastic.shrink_mesh([CPU, CPU], 1), run)
        with pytest.raises(FileNotFoundError):
            elastic.resume(cfg, ta.AdamWConfig(), str(tmp / "none"), mesh2,
                           run)


def test_launcher_trains_then_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` through
    ``main(argv)``: 50 steps write the step-50 checkpoint, and
    ``--resume`` continues from it to step 52."""
    common = ["--arch", "qwen3_4b", "--smoke", "--device", "cpu",
              "--batch", "2", "--seq", "16", "--ckpt", str(tmp_path)]
    _, opt, metrics = launch_train.main(common + ["--steps", "50"])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "training complete" in out
    assert ckpt.latest_step(str(tmp_path)) == 50 and int(opt.step) == 50
    _, opt, metrics = launch_train.main(common + ["--steps", "52",
                                                  "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 50" in out and int(opt.step) == 52
    assert np.isfinite(metrics["loss"])


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Called without a device, the training entry points want CUDA and
    raise where it is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1", "--ckpt",
                           str(tmp_path)])
    cfg = get_smoke_config("qwen3_4b")
    params, opt = fresh(cfg)
    ckpt.save(str(tmp_path / "c"), params, opt, 1, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.restore(str(tmp_path / "c"), 1, {"params": params, "opt": opt})
