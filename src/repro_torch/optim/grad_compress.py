"""Int8 gradient compression with error feedback across data-parallel
groups.

Scale per tensor, quantize, all-reduce the int8 payload as int32 (4x fewer
bytes on the wire than float32), dequantize, and carry the quantization
residual into the next step (error feedback keeps convergence unbiased),
as ``repro.optim.grad_compress`` does.  ``psum_compressed`` takes a
``torch.distributed`` process group where the reference takes a mesh axis
name; the sharded training step (not ported yet) is its caller.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_map

Tree = Any
F32 = torch.float32


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_tree(grads: Tree, residual: Tree | None):
    """Quantize grads (+ the carried residual).  Returns (q_tree, scales,
    new_residual)."""
    if residual is None:
        residual = tree_map(
            lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)
    x = tree_map(lambda g, r: g.to(F32) + r, grads, residual)
    qs = tree_map(quantize_int8, x)
    q, s = _pick(qs, 0), _pick(qs, 1)
    resid = tree_map(lambda xx, qq, ss: xx - dequantize_int8(qq, ss), x, q, s)
    return q, s, resid


def _pick(tree: Tree, i: int) -> Tree:
    """Item ``i`` of every (q, scale) pair in a tree of pairs."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 and torch.is_tensor(tree[0]):
        return tree[i]
    return type(tree)(_pick(v, i) for v in tree)


def psum_compressed(grads: Tree, residual: Tree | None, group=None):
    """Error-feedback int8 all-reduce over ``group`` (the default group
    when None): int8 payloads summed as int32, scales combined by MAX,
    the sum dequantized and divided by the group's size.  Returns
    (mean gradients, new residual)."""
    import torch.distributed as dist

    q, s, resid = compress_tree(grads, residual)

    def summed(qq):
        out = qq.to(torch.int32)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    def s_max(ss):
        out = ss.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out

    n = dist.get_world_size(group)
    deq = tree_map(lambda qq, ss: (qq.to(F32) * ss) / n,
                   tree_map(summed, q), tree_map(s_max, s))
    return deq, resid
