"""AdamW with float32 state, updated in place.

The state tree mirrors the parameter tree (``m``, ``v`` in float32), as in
``repro.optim.adamw``.  The reference is functional; the port updates
``m``, ``v`` and the parameters in place under ``torch.no_grad`` (what
``RunConfig.donate`` means here), a block of leading-axis rows at a time,
so every float32 temporary holds at most ``CHUNK_ELEMS`` elements where a
whole leaf would need 3.6 GB per temporary (qwen3-4b's stacked ``w_gate``
has 896.5 M elements).  The arithmetic is elementwise, so the blocks
change no bit.

On a mesh the tensors are this rank's shards (``state_specs``: the state
is laid out as the parameters are), and the clip scale comes from the
global norm over every rank's shards (``apply_updates(shardings=)``).

``lr``, the clip scale and the bias corrections are 0-d float32 tensors on
the parameters' device, as the reference computes them from its int32
step: Python doubles would move every update by an f32 ulp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

Tree = Any
F32 = torch.float32
#: Elements in one block of rows of the update (256 MB in float32).
CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Tree
    v: Tree


def init_state(params: Tree) -> AdamWState:
    """Zero moments beside each leaf; the step counter (int32) on the
    first leaf's device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def f32(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(f32, params), v=tree_map(f32, params))


def abstract_state(params: Tree) -> AdamWState:
    """The state as ``meta`` tensors: shapes and dtypes only."""
    def f32(p):
        return torch.empty(p.shape, dtype=F32, device="meta")
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(f32, params), v=tree_map(f32, params))


def state_specs(param_spec_tree: Tree) -> AdamWState:
    """The state's specs: m and v as the parameters, the step replicated."""
    from repro_torch.models.sharding import P
    return AdamWState(step=P(), m=param_spec_tree, v=param_spec_tree)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; float32 from
    an int32 step, in the reference's order of operations."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float() /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _blocks(t: torch.Tensor):
    """Index objects covering ``t`` in blocks of leading-axis rows of at
    most ``CHUNK_ELEMS`` elements (at least one row)."""
    if t.dim() == 0 or t.shape[0] == 0:
        return [...]
    rows = max(1, CHUNK_ELEMS // max(t.numel() // t.shape[0], 1))
    return [slice(lo, lo + rows) for lo in range(0, t.shape[0], rows)]


def global_norm(tree: Tree, shardings: Tree = None) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, leaves summed
    in tree order; each leaf's sum of squares is its float32 norm squared,
    which reads the leaf once and makes no float32 copy of it.  With
    ``shardings`` (a tree of ``NamedSharding``), the leaves are shards and
    each leaf's sum covers every rank's shard once."""
    if shardings is None:
        sums = [torch.square(torch.linalg.vector_norm(g, dtype=F32))
                for g in tree_leaves(tree)]
    else:
        from repro_torch.models.sharding import global_sumsq
        sums = global_sumsq(tree, shardings)
    total = 0
    for sq in sums:
        total = total + sq
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def _update(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig) -> None:
    """One block: the reference's ``upd``, writing m, v and p in place."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    delta.add_(p.float() * cfg.weight_decay)
    p.copy_(p.float() - delta.mul_(lr))


def apply_updates(params: Tree, grads: Tree, state: AdamWState,
                  cfg: AdamWConfig, *, shardings: Tree = None):
    """Returns (params, new_state, metrics): ``params``, ``state.m`` and
    ``state.v`` are the given tensors, updated in place; the new state
    holds a new step counter.  ``shardings``: the parameters' placements
    where the tensors are shards (the norm is then the global one)."""
    with torch.no_grad():
        gnorm = global_norm(grads, shardings)
        clip = torch.as_tensor(cfg.grad_clip, dtype=F32, device=gnorm.device)
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        step = state.step + 1
        lr = schedule(cfg, step)
        b1c = 1.0 - cfg.b1 ** step.float()
        b2c = 1.0 - cfg.b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.m), tree_leaves(state.v)):
            for b in _blocks(p):
                _update(p[b], g[b], m[b], v[b], scale, lr, b1c, b2c, cfg)
    return params, AdamWState(step, state.m, state.v), \
        {"gnorm": gnorm, "lr": lr}
