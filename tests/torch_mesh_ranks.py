"""Multi-rank runs of the port on the CPU, for the ``test_torch_mesh_*``
files: ``run_ranks`` starts one process a rank on a gloo group (a
``FileStore`` under the test's temporary directory: no TCP port), runs
``fn(rank, *args)`` in each, and returns each rank's result.  Every join
has its own timeout; a rank that hangs or raises fails the run.

The rank functions here import the port only (no JAX), so that the
spawned interpreters start quickly.
"""
import contextlib
import dataclasses
import os
import pickle
import traceback

import numpy as np
import torch

#: Seconds a multi-rank run may take before its ranks are killed.
RUN_TIMEOUT = 240
STEPS = 2
LR = 3e-4
DATA = dict(seed=0, batch=4, seq_len=16)


def _rank_main(rank, world, store_path, out_dir, fn, args):
    torch.set_num_threads(1)
    import torch.distributed as dist
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        try:
            res = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(("ok", res), f)
    except BaseException:
        with open(out, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def run_ranks(world: int, fn, args, tmp_dir, timeout: float = RUN_TIMEOUT):
    """[fn(rank, *args) for each rank], each run in its own process."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, tmp_dir, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    import time
    deadline = time.monotonic() + timeout
    hung = []
    for r, p in enumerate(procs):
        p.join(max(1.0, deadline - time.monotonic()))
        if p.is_alive():
            hung.append(r)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise AssertionError(f"ranks {hung} of {world} hung past "
                             f"{timeout} s")
    results = []
    for r in range(world):
        path = os.path.join(tmp_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} exited {procs[r].exitcode} "
                                 f"without a result")
        with open(path, "rb") as f:
            status, res = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} failed:\n{res}")
        results.append(res)
    return results


# --------------------------------------------------------------------------
# what the ranks run
# --------------------------------------------------------------------------

def smoke_cfg(arch: str, **moe):
    """The smoke config, with MoE fields replaced where given."""
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def opt_cfg():
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=4)


def init_params(cfg, f32: bool):
    """Seeded weights on the CPU: bf16 as ``init_params`` gives, or
    widened to float32."""
    from repro_torch.models import params as pp
    params = pp.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    return pp.tree_map(lambda t: t.float(), params) if f32 else params


def stream(cfg):
    from repro_torch.data.synthetic import DataConfig, TokenStream
    return TokenStream(cfg, DataConfig(**DATA))


def train(cfg, mesh, run, params, steps=STEPS, first=0, opt=None,
          after_first=None):
    """``steps`` steps of ``make_train_step`` from step ``first``: (params,
    opt, per-step metrics as floats); ``after_first(opt)`` runs after the
    first of them."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    step_fn, for_batch, shard = loop.make_train_step(cfg, opt_cfg(), mesh,
                                                     run)
    if opt is None:
        opt = adamw.init_state(params)
    st, metrics = stream(cfg), []
    for s in range(first, first + steps):
        batch = st.batch_at(s)
        params, opt, m = for_batch(batch)(
            params, opt, batch, loop.step_generator(torch.device("cpu"), s))
        metrics.append({k: float(v) for k, v in m.items()})
        if after_first is not None and s == first:
            after_first(opt)
    return params, opt, metrics, shard


def one_device_train(cfg, run, f32, steps=STEPS):
    """(params, opt, metrics) after ``steps`` one-device steps, and (m, v)
    after the first."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import params as pp
    first = []
    params, opt, metrics, _ = train(
        cfg, make_host_mesh(device="cpu"), run, init_params(cfg, f32),
        steps, after_first=lambda o: first.append(
            (pp.tree_map(torch.clone, o.m), pp.tree_map(torch.clone, o.v))))
    return params, opt, metrics, first[0]


def _numpy_tree(tree):
    """Copies of the leaves (a gathered replicated leaf is the live
    tensor, which later steps update in place)."""
    from repro_torch.models import params as pp
    return [np.array(t.float()) for t in pp.tree_leaves(tree)]


def _shapes(tree):
    from repro_torch.models import params as pp
    return [tuple(t.shape) for t in pp.tree_leaves(tree)]


def train_case(rank, case):
    """One sharded training case on the world's mesh: metrics, local
    shard shapes of params and m, and, on rank 0, the whole params after
    the steps and m and v after the first, as numpy."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.train import loop
    cfg = smoke_cfg(case["arch"], **case.get("moe", {}))
    mesh = make_host_mesh(case["model"], device="cpu")
    run = loop.RunConfig(fsdp=case["fsdp"], remat=True,
                         grad_accum=case["accum"])
    p_shard = loop.param_shardings(cfg, mesh, run)
    params = sh.shard_tree(init_params(cfg, case["f32"]), p_shard)
    first = []
    params, opt, metrics, _ = train(
        cfg, mesh, run, params, after_first=lambda o: first.extend(
            _numpy_tree(sh.gather_tree(t, p_shard)) for t in (o.m, o.v)))
    out = {"metrics": metrics, "shapes": _shapes(params),
           "m_shapes": _shapes(opt.m), "mesh": mesh.shape}
    whole = _numpy_tree(sh.gather_tree(params, p_shard))
    if rank == 0:
        out["whole"] = (whole, *first)
    return out


def serve_case(rank, case):
    """Sharded prefill, then ``DECODE_STEPS`` decode steps, of the seeded
    weights on the world's mesh: the whole logits of each, and this
    rank's cache shard shapes."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as mm
    from repro_torch.models import sharding as sh
    from repro_torch.train import loop
    cfg = smoke_cfg(case["arch"])
    mesh = make_host_mesh(case["model"], device="cpu")
    run = loop.RunConfig(fsdp=case["fsdp"])
    B, T = case["batch"], case["max_len"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 6))
    p_shard = loop.param_shardings(cfg, mesh, run)
    params = sh.shard_tree(init_params(cfg, False), p_shard)
    _, for_batch, _ = loop.make_prefill_step(cfg, mesh, B, run)
    out = {"prefill": for_batch({"tokens": toks})(
        params, {"tokens": toks}).float().numpy()}
    serve_step, _, (_, c_shard) = loop.make_decode_step(cfg, mesh, B, run)
    caches = sh.shard_tree(mm.init_cache(cfg, B, T, device="cpu"), c_shard)
    out["cache_shapes"] = _shapes(caches)
    logits = []
    for t in range(toks.shape[1]):
        lg, caches = serve_step(params, torch.from_numpy(toks[:, t: t + 1]),
                                caches, t)
        logits.append(lg.float().numpy())
    out["decode"] = logits
    return out


@contextlib.contextmanager
def small_blocks():
    """Sharded checkpoints moved in blocks of ``CKPT_BLOCK`` bytes: a
    stacked leaf a unit at a time, a norm a few rows at a time."""
    from repro_torch.train import checkpoint as ckpt
    saved, ckpt.BLOCK_BYTES = ckpt.BLOCK_BYTES, CKPT_BLOCK
    try:
        yield
    finally:
        ckpt.BLOCK_BYTES = saved


CKPT_BLOCK = 64


def save_case(rank, case):
    """``STEPS`` sharded steps through ``train_loop`` on the world's mesh
    (every rank; rank 0 writes), with a checkpoint after the first: each
    step's metrics."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop
    cfg = smoke_cfg(case["arch"])
    mesh = make_host_mesh(case["model"], device="cpu")
    run = loop.RunConfig(fsdp=case["fsdp"], remat=True)
    seen = []
    with small_blocks():
        params, opt, _ = loop.train_loop(
            cfg, opt_cfg(), mesh, stream(cfg), 1, run,
            checkpoint_dir=case["dir"], checkpoint_every=1,
            on_metrics=lambda s, m: seen.append(m))
    ckpt.wait_for_writes()
    from repro_torch.models import sharding as sh
    p_shard = loop.param_shardings(cfg, mesh, run)
    saved = _numpy_tree({"params": sh.gather_tree(params, p_shard),
                         "opt": sh.gather_tree(opt, loop._state_shardings(
                             mesh, p_shard))})
    loop.train_loop(cfg, opt_cfg(), mesh, stream(cfg), STEPS, run,
                    start_step=1, params=params, opt_state=opt,
                    on_metrics=lambda s, m: seen.append(m))
    return {"metrics": seen, "saved": saved if rank == 0 else None}


def resume_case(rank, case):
    """The elastic path on the survivors' world: ``shrink_mesh`` keeps
    the model axis, ``resume`` re-shards the checkpoint of ``case["step"]``
    onto it, and training continues to ``STEPS``: each step's metrics,
    this rank's shard shapes, and on rank 0 the whole params."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import world_devices
    from repro_torch.models import sharding as sh
    from repro_torch.train import elastic, loop
    cfg = smoke_cfg(case["arch"])
    mesh = elastic.shrink_mesh(world_devices(torch.device("cpu")),
                               model_parallel=case["model"])
    run = loop.RunConfig(fsdp=case["fsdp"], remat=True)
    with small_blocks():
        params, opt, step = elastic.resume(cfg, opt_cfg(), case["dir"],
                                           mesh, run)
    shapes = _shapes(params)
    seen = []
    params, opt, _ = loop.train_loop(cfg, opt_cfg(), mesh, stream(cfg),
                                     STEPS, run, start_step=step,
                                     params=params, opt_state=opt,
                                     on_metrics=lambda s, m: seen.append(m))
    whole = sh.gather_tree(params, loop.param_shardings(cfg, mesh, run))
    out = {"step": step, "metrics": seen, "shapes": shapes,
           "mesh": mesh.shape, "world": dist.get_world_size()}
    if rank == 0:
        out["whole"] = _numpy_tree(whole)
    return out


def launcher_case(rank, case):
    """``python -m repro_torch.launch.train`` on every rank of the world
    (its process group already up, as ``torchrun`` brings it up)."""
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, opt, metrics = launch_train.main(case["argv"])
    return {"metrics": metrics, "step": int(opt.step),
            "stdout": buf.getvalue()}


@contextlib.contextmanager
def counting_collectives():
    """Counts the output bytes of every all-gather, reduce-scatter and
    all-reduce that this process sends, by kind (the keys of the dry
    run's ``collectives``)."""
    import torch.distributed as dist
    counts = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    names = {"all_gather_into_tensor": "all-gather",
             "all_gather_single": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_single": "reduce-scatter",
             "all_reduce": "all-reduce"}
    saved = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def counted(fn, kind):
        def call(out, *args, **kwargs):
            counts[kind] += out.numel() * out.element_size()
            return fn(out, *args, **kwargs)
        return call
    for n, fn in saved.items():
        setattr(dist, n, counted(fn, names[n]))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def count_case(rank, case):
    """The collective bytes of one sharded train step, one prefill and
    one decode step (``case["shapes"]``: kind -> (seq_len, batch)) on the
    world's mesh, by kind."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as mm
    from repro_torch.models import sharding as sh
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg = smoke_cfg(case["arch"], **case.get("moe", {}))
    mesh = make_host_mesh(case["model"], device="cpu")
    out = {}
    for kind, (S, B) in case["shapes"].items():
        run = loop.RunConfig(fsdp=case["fsdp"], remat=True,
                             grad_accum=case["accum"] if kind == "train"
                             else 1)
        p_shard = loop.param_shardings(cfg, mesh, run)
        params = sh.shard_tree(init_params(cfg, False), p_shard)
        rng = np.random.default_rng(2)
        if kind == "train":
            from repro_torch.data.synthetic import DataConfig, TokenStream
            batch = TokenStream(cfg, DataConfig(seed=0, batch=B,
                                                seq_len=S)).batch_at(0)
            step_fn, _, _ = loop.make_train_step(cfg, opt_cfg(), mesh, run)
            opt = adamw.init_state(params)
            with counting_collectives() as counts:
                step_fn(params, opt, batch,
                        loop.step_generator(torch.device("cpu"), 0))
        elif kind == "prefill":
            toks = rng.integers(0, cfg.vocab_size, (B, S))
            step, _, _ = loop.make_prefill_step(cfg, mesh, B, run)
            with counting_collectives() as counts:
                step(params, {"tokens": toks})
        else:
            step, _, (_, c_shard) = loop.make_decode_step(cfg, mesh, B, run)
            caches = sh.shard_tree(mm.init_cache(cfg, B, S, device="cpu"),
                                   c_shard)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
            with counting_collectives() as counts:
                step(params, toks, caches, 1)
        out[kind] = dict(counts)
    return out


def all_cases(rank, items):
    """Each (kind, case) of ``items`` in turn."""
    run = {"train": train_case, "serve": serve_case, "save": save_case,
           "resume": resume_case, "launcher": launcher_case,
           "count": count_case}
    return [run[kind](rank, case) for kind, case in items]


# --------------------------------------------------------------------------
# SpMV on the mesh (test_torch_mesh_spmv.py)
# --------------------------------------------------------------------------

def spmv_matrix(spec):
    """The port's generator for ``(name, scale)``."""
    from repro_torch.data.matrices import make_matrix
    name, scale = spec
    return make_matrix(name, scale=scale)


def spmv_x(n: int, B, seed: int):
    """The seeded x of a case: (n,) for ``B`` None, else (n, B)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if B is None else (n, B))


@contextlib.contextmanager
def counting_sends():
    """The input bytes (what this rank sends) of every all-to-all and
    all-gather, by kind."""
    import torch.distributed as dist
    counts = {"all-to-all": 0, "all-gather": 0}
    names = {"all_to_all_single": "all-to-all",
             "all_gather_into_tensor": "all-gather",
             "all_gather_single": "all-gather"}
    saved = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def counted(fn, kind):
        def call(out, x, *args, **kwargs):
            counts[kind] += x.numel() * x.element_size()
            return fn(out, x, *args, **kwargs)
        return call
    for n, fn in saved.items():
        setattr(dist, n, counted(fn, names[n]))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _spmv_program(case):
    from repro_torch.core import program as P
    from repro_torch.core.spmv import SpmvPlan
    A = spmv_matrix(case["matrix"])
    return A, P.lower(A, SpmvPlan(**case["plan"]))


def spmv_ref_case(mesh, case):
    """``execute(..., backend="shard_map")`` on the world's mesh."""
    from repro_torch.core import program as P
    A, prog = _spmv_program(case)
    return P.execute(prog, spmv_x(A.ncols, case["B"], case["seed"]),
                     backend="shard_map", mesh=mesh)


def spmv_exec_case(mesh, case):
    """The executor at B = 1 and 3, pipeline on and off: this rank's
    y block, the gathered y, the bytes each call's exchange and the y
    gather sent, the operands' first dimensions and the block."""
    from repro_torch.core import program as P
    A, prog = _spmv_program(case)
    out = {}
    for B in (None, 3):
        x = spmv_x(A.ncols, B, case["seed"])
        xp = x if prog.perm is None else P._apply_perm(x, prog.perm)
        xs = prog.x_to_device(xp.astype(np.float32))
        for pipeline in (True, False):
            run = P.make_program_spmv_fn(prog, mesh, pipeline=pipeline)
            with counting_sends() as sent:
                block = run(xs)
            with counting_sends() as gathered:
                y = P.gather_b(prog, block, mesh)
            out[(B, pipeline)] = dict(
                block=block.numpy(), y=y, sent=dict(sent),
                gathered=dict(gathered), shards=run.shards,
                operand_rows={k: int(t.shape[0])
                              for k, t in run.operands.items()})
    return out


def spmv_shim_case(mesh, case):
    """The three legacy shims with the reference's positional mesh: the
    gathered y of each."""
    import warnings
    from repro_torch.core import program as P
    from repro_torch.core import spmv as S
    A, prog = _spmv_program(case)
    x = spmv_x(A.ncols, case["B"], case["seed"])
    xs = prog.x_to_device(x.astype(np.float32))
    halo = S.build_halo(prog)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        out["make_spmv_fn"] = S.make_spmv_fn(prog, mesh)(
            prog.data, prog.cols, xs)
        out["make_halo_spmv_fn"] = S.make_halo_spmv_fn(prog, halo, mesh)(
            prog.data, halo.cols_remap, halo.send_idx, xs)
        if prog.seg_vals is not None:
            out["make_seg_spmv_fn"] = S.make_seg_spmv_fn(prog, mesh,
                                                         "model")(
                prog.seg_vals, prog.seg_cols, prog.seg_rows,
                prog.seg_pieces, xs)
    return {k: P.gather_b(prog, v, mesh) for k, v in out.items()}


def spmv_error_case(mesh, case):
    """The ``ValueError`` message each misuse raises (None if it ran)."""
    from repro_torch.core import program as P
    from repro_torch.core.spmv import SpmvPlan
    A = spmv_matrix(case["matrix"])
    W = mesh.shape["model"]
    cuda = dataclasses.replace(mesh, devices=(torch.device("cuda", 0),) * W)
    calls = {
        "indivisible": lambda: P.make_program_spmv_fn(
            P.lower(A, SpmvPlan(num_shards=W + 1, kernel="seg")), mesh),
        "cuda_on_gloo": lambda: P.make_program_spmv_fn(
            P.lower(A, SpmvPlan(num_shards=W, kernel="seg")), cuda),
        "graphs": lambda: P.make_program_spmv_fn(
            P.lower(A, SpmvPlan(num_shards=W, kernel="seg")), mesh,
            graphs=True),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def spmv_cases(rank, items):
    """Each (kind, case) of ``items`` on one ("model",) mesh over the
    world."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import build_mesh, world_devices
    mesh = build_mesh(("model",), (dist.get_world_size(),),
                      world_devices(torch.device("cpu")))
    run = {"ref": spmv_ref_case, "exec": spmv_exec_case,
           "shim": spmv_shim_case, "errors": spmv_error_case}
    return [run[kind](mesh, case) for kind, case in items]
