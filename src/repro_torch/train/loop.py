"""Train and serve step factories + the training loop, on a mesh.

``make_train_step`` builds the step for a (config, mesh) pair: the loss's
gradients through ``torch.autograd`` (per-unit remat, gradient
accumulation in float32), then AdamW in place.  ``make_decode_step`` and
``make_prefill_step`` are the serving versions.

On a distributed mesh (``launch.mesh``) each rank holds its shards:
parameters and Adam state under ``param_specs`` / ``state_specs`` (ZeRO-3
FSDP of both over "data" where ``RunConfig.fsdp``, TP storage over
"model"), its rows of the batch over ("pod", "data") (``batch_specs``;
micro-batches re-placed as ``P(None, batch_axes)``) and, in decode, its
block of the caches (``cache_specs``: the KV positions over "model").  A
"sharding" is a ``sharding.NamedSharding``.  On a local mesh of one
device the steps run as in the one-device port; a local mesh of more than
one device raises, so nothing trains quietly on one of its devices.
``compress_pod_grads`` is read by nothing, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as mm
from repro_torch.models import params as pp
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import P
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

Tree = Any
F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RunConfig:
    fsdp: bool = True
    remat: bool = True
    # The reference donates the parameter and state buffers to its jitted
    # step; here the step updates them in place (False: on copies).
    donate: bool = True
    compress_pod_grads: bool = False
    step_deadline_s: float = 0.0     # 0 = no straggler deadline
    model_axis: str = "model"
    # Steers XLA's layer scan in the reference; the port has no scan.
    scan_unroll: object = False
    # Gradient accumulation: the batch is split into this many
    # micro-batches a step, their gradients summed in float32.
    grad_accum: int = 1


def batch_axes_of(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in mm._BATCH)


def batch_parts(mesh: Mesh) -> int:
    """The number of batch shards: the batch axes' sizes' product."""
    n = 1
    for a in batch_axes_of(mesh):
        n *= mesh.shape[a]
    return n


def batch_split(mesh: Mesh, batch: int) -> bool:
    """Whether a batch of ``batch`` rows splits over the batch axes (they
    divide it), as the reference's specs decide; else it is
    replicated."""
    nb = batch_parts(mesh)
    return batch % nb == 0 and batch >= nb


def batch_specs(cfg: ModelConfig, mesh: Mesh, shape_batch: int) -> Tree:
    """A function of an input's name to its spec: the batch axes where
    they divide the batch, else replicated (as the reference)."""
    lead = P(batch_axes_of(mesh)) if batch_split(mesh, shape_batch) else P()

    def spec_like(name):
        return lead
    return spec_like


def _named(mesh: Mesh, spec_tree: Tree) -> Tree:
    return sh.map_specs(lambda s: sh.NamedSharding(mesh, s), spec_tree)


def _check_mesh(mesh: Mesh) -> None:
    if mesh.abstract:
        raise ValueError("an abstract mesh has no devices to run on")
    if not mesh.distributed and mesh.size != 1:
        raise RuntimeError(
            f"a mesh of {mesh.size} devices {mesh.shape} without a process "
            f"group over them: start one process per device (torchrun), "
            f"so that nothing trains on one of them alone")


def param_specs_for(cfg: ModelConfig, mesh: Mesh, run: RunConfig) -> Tree:
    data_axis = "data" if "data" in mesh.axis_names else None
    return pp.param_specs(cfg, fsdp=run.fsdp and data_axis is not None,
                          data_axis=data_axis, model_axis=run.model_axis)


def param_shardings(cfg: ModelConfig, mesh: Mesh, run: RunConfig) -> Tree:
    """The parameter tree's placements (``NamedSharding``s)."""
    _check_mesh(mesh)
    return _named(mesh, param_specs_for(cfg, mesh, run))


def _state_shardings(mesh, p_shard):
    return adamw.AdamWState(step=sh.NamedSharding(mesh, P()), m=p_shard,
                            v=p_shard)


def _placement(cfg, mesh, run, batch: int, cache_spec=None):
    return sh.Placement(
        mesh, batch_axes_of(mesh), batch_split(mesh, batch),
        param_specs_for(cfg, mesh, run), cache_spec,
        run.model_axis if run.model_axis in mesh.axis_names else None)


def _rows(place, x, micro: int = 1, device=None) -> torch.Tensor:
    """This rank's rows of a whole input (numpy or a tensor): each of
    ``micro`` micro-batches split over the batch axes (``P(None,
    batch_axes)``), on the mesh's device (``device`` without a
    placement); shape (micro * rows, ...)."""
    x = torch.as_tensor(x, device=device if place is None
                        else place.mesh.local_device)
    if place is None or not place.batch_sharded:
        return x
    mb = x.reshape(micro, x.shape[0] // micro, *x.shape[1:])
    return sh.local_block(mb, 1, place.mesh, place.batch_axes).reshape(
        -1, *x.shape[1:])


def place_batch(place, batch: Dict[str, Any], micro: int = 1,
                device=None) -> Dict[str, torch.Tensor]:
    return {k: _rows(place, v, micro, device) for k, v in batch.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def step_generator(device, step: int) -> torch.Generator:
    """One step's generator, seeded with the step, as the reference folds
    the step into its key (``fold_in(PRNGKey(0), step)``)."""
    return torch.Generator(device=device).manual_seed(step)


def _whole_rows(place, x: torch.Tensor) -> torch.Tensor:
    """Every batch shard's rows of an output (dim 0), gathered; ``x``
    itself without a placement."""
    if place is None or not place.batch_sharded:
        return x
    return sh.all_gather(x, 0, place.mesh, place.batch_axes)


def _rows_of(batch: Dict[str, Any]) -> int:
    return len(next(iter(batch.values())))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh: Mesh,
                    run: RunConfig = RunConfig()):
    """Returns (step_fn, for_batch, (param shardings, state shardings)).

    ``step_fn(params, opt_state, batch, generator=None)`` -> (params,
    opt_state, metrics) takes the whole batch (numpy or tensors; on a
    distributed mesh every rank the same, as the counter-based
    ``TokenStream`` gives it) and places this rank's rows on the device;
    ``params`` and ``opt_state`` are this rank's shards.
    ``for_batch(batch)`` returns ``step_fn``, as the reference returns
    its step compiled for batches shaped like ``batch``.  ``metrics``
    holds 0-d float32 tensors: loss, ce, aux, gnorm, lr, equal on every
    rank."""
    p_shard = param_shardings(cfg, mesh, run)
    o_shard = _state_shardings(mesh, p_shard)
    dev = mesh.local_device

    def loss_and_grads(params, batch, generator, place):
        live = pp.tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = pp.tree_leaves(live)
        with torch.enable_grad(), \
                (sh.use(place) if place else contextlib.nullcontext()):
            loss, metrics = mm.loss_fn(live, cfg, batch, generator=generator,
                                       remat=run.remat)
            # a leaf the loss does not read (the embedding table of an
            # audio-frame frontend) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                pp.tree_unflatten(params, grads))

    def step_fn(params, opt_state, batch, generator=None):
        if not run.donate:
            with torch.no_grad():
                params = pp.tree_map(torch.clone, params)
                opt_state = pp.tree_map(torch.clone, opt_state)
        n = run.grad_accum
        place = None
        if mesh.distributed:
            place = _placement(cfg, mesh, run, _rows_of(batch))
            if place.batch_sharded and (_rows_of(batch) // n) % \
                    place.batch_parts:
                raise ValueError(
                    f"micro-batches of {_rows_of(batch) // n} rows do not "
                    f"split over {place.batch_parts} batch shards")
        batch = place_batch(place, batch, n, dev)
        if n == 1:
            loss, metrics, grads = loss_and_grads(params, batch, generator,
                                                  place)
        else:
            micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                     for k, v in batch.items()}
            grads = pp.tree_map(
                lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                params)
            loss = torch.zeros((), dtype=F32, device=dev)
            start = None if generator is None else generator.get_state()
            for i in range(n):
                if start is not None:
                    # each micro-batch draws what the first drew, as the
                    # reference hands each one the step's key
                    generator.set_state(start)
                l, _, g = loss_and_grads(
                    params, {k: v[i] for k, v in micro.items()}, generator,
                    place)
                with torch.no_grad():
                    for acc, gg in zip(pp.tree_leaves(grads),
                                       pp.tree_leaves(g)):
                        acc.add_(gg.float() / n)
                del g
                loss = loss + l / n
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=F32,
                                                      device=dev)}
        if place is not None:
            # each rank holds its share of the loss: the sum is the loss
            loss = place.batch_sum(loss)
            metrics = {k: place.batch_sum(v) for k, v in metrics.items()}
        params, opt_state, om = adamw.apply_updates(
            params, grads, opt_state, opt_cfg,
            shardings=p_shard if mesh.distributed else None)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step_fn, lambda batch_tree: step_fn, (p_shard, o_shard)


def block_cache_spec(cfg: ModelConfig, mesh: Mesh, batch: int, kind: str):
    """One block's cache specs (no leading unit axis), as the reference's
    ``cache_specs``: KV positions over "model" (local attention's ring
    buffer whole), recurrent states over "model" where it divides them,
    the batch over the batch axes where they divide it."""
    b = batch_axes_of(mesh) if batch_split(mesh, batch) else None
    ma = "model"
    if kind == "local_attn":
        return (P(b, None, None, None), P(b, None, None, None))
    if kind in ("attn", "moe"):
        return (P(b, ma, None, None), P(b, ma, None, None))
    if kind == "mlstm":
        dk_ok = (int(cfg.d_model * cfg.lstm_proj_factor) //
                 cfg.num_heads) % mesh.shape[ma] == 0
        m = ma if dk_ok else None
        return (P(b, None, m, None), P(b, None, m))
    if kind == "slstm":
        return (P(b), P(b), P(b), P(b))
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        m = ma if w % mesh.shape[ma] == 0 else None
        return (P(b, m), P(b, None, m))
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, mesh: Mesh, batch: int) -> Tree:
    """The spec tree matching ``abstract_cache``'s structure."""
    unit = cfg.pattern()
    n_scan = cfg.num_layers - cfg.dense_first_layers
    tail_kinds = unit[: n_scan % len(unit)]

    def stack_spec(kind):
        return tuple(P(None, *s) for s in block_cache_spec(cfg, mesh, batch,
                                                           kind))

    return {
        "stack": {f"u{j}_{k}": stack_spec(k) for j, k in enumerate(unit)},
        "tail": {f"t{j}_{k}": block_cache_spec(cfg, mesh, batch, k)
                 for j, k in enumerate(tail_kinds)},
        "prefix": {f"p{j}_{unit[0]}": block_cache_spec(cfg, mesh, batch,
                                                       unit[0])
                   for j in range(cfg.dense_first_layers)},
    }


def make_decode_step(cfg: ModelConfig, mesh: Mesh, batch: int,
                     run: RunConfig = RunConfig()):
    """Returns (serve_step, serve_step, (param shardings, cache
    shardings)); the reference's second item is its jitted step.
    ``serve_step(params, tokens, caches, pos)`` takes this rank's
    parameter and cache shards and the whole (B, 1) tokens, and returns
    the whole logits; the caches are updated in place."""
    p_shard = param_shardings(cfg, mesh, run)
    c_shard = _named(mesh, cache_specs(cfg, mesh, batch))
    place = _placement(cfg, mesh, run, batch, cache_spec=lambda kind:
                       block_cache_spec(cfg, mesh, batch, kind)) \
        if mesh.distributed else None

    def serve_step(params, tokens, caches, pos):
        with torch.no_grad(), \
                (sh.use(place) if place else contextlib.nullcontext()):
            logits, caches = mm.decode_step(
                params, cfg, _rows(place, tokens, device=mesh.local_device),
                caches, pos)
            return _whole_rows(place, logits), caches
    return serve_step, serve_step, (p_shard, c_shard)


def make_prefill_step(cfg: ModelConfig, mesh: Mesh, batch: int,
                      run: RunConfig = RunConfig()):
    """Returns (prefill_step, for_batch, param shardings).
    ``prefill_step(params, batch_inputs)`` takes this rank's parameter
    shards and the whole batch (numpy or tensors), and returns the whole
    last-position logits; ``for_batch`` returns it."""
    p_shard = param_shardings(cfg, mesh, run)
    place = _placement(cfg, mesh, run, batch) if mesh.distributed else None

    def prefill_step(params, batch_inputs):
        with torch.no_grad(), \
                (sh.use(place) if place else contextlib.nullcontext()):
            return _whole_rows(place, mm.prefill(
                params, cfg,
                place_batch(place, batch_inputs, device=mesh.local_device)))
    return prefill_step, lambda batch_tree: prefill_step, p_shard


def init_sharded(cfg: ModelConfig, mesh: Mesh, run: RunConfig,
                 generator: torch.Generator):
    """(params, opt_state) on ``mesh``: ``init_params`` drawn from
    ``generator`` on this rank's device (every rank draws the same), this
    rank's shard of each draw kept before the next is drawn, so that one
    leaf (a stacked leaf's unit) at most is whole on the device."""
    keep = None
    if mesh.distributed:
        shardings = param_shardings(cfg, mesh, run)

        def keep(path, w):
            s = shardings
            for k in path:
                s = s[k]
            if path[0] == "stack":          # one unit's leaf
                s = sh.NamedSharding(mesh, P(*s.spec[1:]))
            return s.local(w)
    params = pp.init_params(cfg, generator, device=mesh.local_device,
                            keep=keep)
    return params, adamw.init_state(params)


def train_loop(cfg: ModelConfig, opt_cfg, mesh: Mesh, stream, steps: int,
               run: RunConfig = RunConfig(), *, checkpoint_dir=None,
               checkpoint_every: int = 0, start_step: int = 0,
               params=None, opt_state=None, on_metrics=None):
    """Host training loop with checkpoints and a straggler deadline.
    Without ``params``, initialises them with ``init_params`` from a
    generator seeded with 0 on the mesh's device (on a distributed mesh:
    this rank's shards of them).  Every rank runs it; rank 0 writes the
    checkpoints (whole arrays)."""
    from repro_torch.train import checkpoint as ckpt
    step_fn, _, (p_shard, o_shard) = make_train_step(cfg, opt_cfg, mesh,
                                                     run)
    dev = mesh.local_device
    if params is None:
        params, opt_state = init_sharded(
            cfg, mesh, run, torch.Generator(device=dev).manual_seed(0))
    shardings = {"params": p_shard, "opt": o_shard} \
        if mesh.distributed else None
    metrics = {}
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state,
                                             stream.batch_at(step),
                                             step_generator(dev, step))
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if run.step_deadline_s and dt > run.step_deadline_s:
            metrics["straggler"] = dt       # deadline breach -> logged + hook
        if on_metrics:
            on_metrics(step, metrics)
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, params, opt_state, step + 1,
                      shardings=shardings)
    return params, opt_state, metrics
