"""The train and serve step factories and the training loop, on one device.

``make_train_step`` builds the step for a (config, mesh) pair: the loss's
gradients through ``torch.autograd`` (per-unit remat, gradient
accumulation in float32), then AdamW in place.  ``make_decode_step`` and
``make_prefill_step`` are the serving versions.  A "sharding" here is the
placement on the mesh's single device.  A mesh of more than one device
raises ``NotImplementedError``: sharded training (FSDP and TP of the
parameters and the Adam state, int8 gradient compression across pods) is
not ported yet, and nothing trains quietly on one of the devices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as mm
from repro_torch.models import params as pp
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
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def mesh_device(mesh: Mesh) -> torch.device:
    """The mesh's one device; raises for a mesh of more than one."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"a mesh of {mesh.size} devices {mesh.shape}: the port trains "
            f"and serves on one device; sharded training is the next item "
            f"of ROADMAP.md's Queue 1")
    return mesh.devices[0]


def param_shardings(cfg: ModelConfig, mesh: Mesh, run: RunConfig) -> Tree:
    """The parameter tree's placements: the mesh's device for every
    leaf."""
    dev = mesh_device(mesh)
    return pp.tree_map(lambda _: dev, pp.abstract_params(cfg))


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def step_generator(device, step: int) -> torch.Generator:
    """One step's generator, seeded with the step, as the reference folds
    the step into its key (``fold_in(PRNGKey(0), step)``)."""
    return torch.Generator(device=device).manual_seed(step)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh: Mesh,
                    run: RunConfig = RunConfig()):
    """Returns (step_fn, for_batch, (param placements, state placements)).

    ``step_fn(params, opt_state, batch, generator=None)`` -> (params,
    opt_state, metrics) takes a batch of tensors on the device;
    ``for_batch(batch)`` returns the step for batches shaped like
    ``batch``, which moves each batch (numpy or tensors) to the device.
    ``metrics`` holds 0-d float32 tensors: loss, ce, aux, gnorm, lr."""
    p_place = param_shardings(cfg, mesh, run)
    dev = mesh_device(mesh)
    o_place = adamw.AdamWState(step=dev, m=p_place, v=p_place)

    def loss_and_grads(params, batch, generator):
        live = pp.tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = pp.tree_leaves(live)
        with torch.enable_grad():
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
        if n == 1:
            loss, metrics, grads = loss_and_grads(params, batch, generator)
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
                    params, {k: v[i] for k, v in micro.items()}, generator)
                with torch.no_grad():
                    for acc, gg in zip(pp.tree_leaves(grads),
                                       pp.tree_leaves(g)):
                        acc.add_(gg.float() / n)
                del g
                loss = loss + l / n
            metrics = {"ce": loss, "aux": torch.zeros((), dtype=F32,
                                                      device=dev)}
        params, opt_state, om = adamw.apply_updates(params, grads, opt_state,
                                                    opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    def for_batch(batch_tree: Tree):
        def step(params, opt_state, batch, generator=None):
            return step_fn(params, opt_state, to_device(batch, dev),
                           generator)
        return step
    return step_fn, for_batch, (p_place, o_place)


def make_decode_step(cfg: ModelConfig, mesh: Mesh, batch: int,
                     run: RunConfig = RunConfig()):
    """Returns (serve_step, serve_step, (param placements, cache
    placements)); the reference's second item is its jitted step."""
    p_place = param_shardings(cfg, mesh, run)
    dev = mesh_device(mesh)
    c_place = pp.tree_map(lambda _: dev, mm.abstract_cache(cfg, batch, 1))

    def serve_step(params, tokens, caches, pos):
        return mm.decode_step(params, cfg, tokens, caches, pos)
    return serve_step, serve_step, (p_place, c_place)


def make_prefill_step(cfg: ModelConfig, mesh: Mesh, batch: int,
                      run: RunConfig = RunConfig()):
    """Returns (prefill_step, for_batch, param placements)."""
    p_place = param_shardings(cfg, mesh, run)
    dev = mesh_device(mesh)

    def prefill_step(params, batch_inputs):
        return mm.prefill(params, cfg, batch_inputs)

    def for_batch(batch_tree: Tree):
        def step(params, batch_inputs):
            return prefill_step(params, to_device(batch_inputs, dev))
        return step
    return prefill_step, for_batch, p_place


def train_loop(cfg: ModelConfig, opt_cfg, mesh: Mesh, stream, steps: int,
               run: RunConfig = RunConfig(), *, checkpoint_dir=None,
               checkpoint_every: int = 0, start_step: int = 0,
               params=None, opt_state=None, on_metrics=None):
    """Host training loop with checkpoints and a straggler deadline.
    Without ``params``, initialises them with ``init_params`` from a
    generator seeded with 0 on the mesh's device."""
    from repro_torch.train import checkpoint as ckpt
    dev = mesh_device(mesh)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = pp.init_params(cfg, gen, device=dev)
        opt_state = adamw.init_state(params)
    _, for_batch, _ = make_train_step(cfg, opt_cfg, mesh, run)
    step_fn = None
    metrics = {}
    for step in range(start_step, steps):
        batch = stream.batch_at(step)
        if step_fn is None:
            step_fn = for_batch(batch)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             step_generator(dev, step))
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if run.step_deadline_s and dt > run.step_deadline_s:
            metrics["straggler"] = dt       # deadline breach -> logged + hook
        if on_metrics:
            on_metrics(step, metrics)
        if checkpoint_dir and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, params, opt_state, step + 1)
    return params, opt_state, metrics
