"""Sharding on a ``Mesh``: partition specs, placements, and the collectives
that the sharded train and serve steps run, on local shards.

The reference leaves partitioning to GSPMD: ``NamedSharding`` places each
array, ``with_sharding_constraint`` re-lays an activation, and XLA inserts
the collectives.  The port keeps every tensor as this rank's local shard
(a plain tensor) and runs the collectives itself, ZeRO-3 style:

* a parameter is stored as its shard under ``param_specs`` (FSDP over
  "data", TP over "model"); a layer gathers it where it runs
  (``gather_param``, per pattern unit inside the remat checkpoint, so the
  recompute gathers again): whole, or but for "model" where the layer
  splits its products (tensor parallelism: attention's heads, a dense
  FFN's or the shared experts' columns, Megatron style, ``tp_enter`` and
  ``tp_leave``); the gather's backward sums the gradient over the batch
  axes and keeps this rank's shard;
* the batch is split over the batch axes ("pod", "data"); the model axis
  also splits the MoE's experts (expert parallelism) and the decode
  cache's positions, and holds replicas of the rest;
* every collective's backward keeps one rule: a rank's gradient of a
  tensor that is replicated over the batch axes is its own loss's
  share (the shares are summed where the gradient reaches a parameter or
  a batch shard), and over the model axis it is the whole gradient.

``P`` is a tuple of mesh axes, ``None`` or a tuple of axes per dim, as
``jax.sharding.PartitionSpec`` compares as a tuple.  ``resolve_spec`` is
the reference's constraint rule (``_maybe_constrain``) as a pure
function.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Any
F32 = torch.float32


class P(tuple):
    """A partition spec: one entry a dim, a mesh axis name, a tuple of
    names, or None (replicated).  As ``PartitionSpec`` normalises them, a
    one-name tuple is stored as the name and an empty one as None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) <= 1:
                return e[0] if e else None
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def resolve_spec(shape, axes, mesh_shape: Dict[str, int]) -> P:
    """The reference's constraint rule: ``axes`` gives one axis, a tuple
    of axes, or None per dim; axes not in the mesh are dropped, and a dim
    that the remaining axes' product does not divide (or that is smaller
    than it) is left whole."""
    out = []
    for n, a in zip(shape, axes):
        cand = tuple(c for c in entry_axes(a) if c in mesh_shape)
        size = 1
        for c in cand:
            size *= mesh_shape[c]
        if not cand or n % size or n < size:
            out.append(None)
        else:
            out.append(cand if len(cand) > 1 else cand[0])
    return P(*out)


def _parts(entry, mesh_shape) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= mesh_shape[a]
    return n


def shard_shape(shape, spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """A shard's shape: each dim divided (rounded up, as a padded shard)
    by the product of its axes' sizes; dims past the spec are whole."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-n // _parts(e, mesh_shape)) for n, e in zip(shape, spec))


def map_specs(fn, tree):
    """``fn`` on every ``P`` of a nested dict / tuple / NamedTuple tree."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [map_specs(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in ``tree_leaves``'s order (dict keys
    sorted, sequences and NamedTuple fields in order)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


# --------------------------------------------------------------------------
# collectives on local shards
# --------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def _gather_into(out, x, group):
    # all_gather_single is all_gather_into_tensor's newer name
    dist = _dist()
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)


def _scatter_into(out, x, group):
    dist = _dist()
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, x, group=group)


def block_index(mesh, axes) -> Tuple[int, int]:
    """(index, count) of this rank's block along ``axes`` (row-major)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.coordinate(a)
        n *= mesh.shape[a]
    return idx, n


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The blocks of every rank along ``axes``, concatenated on ``dim``."""
    _, n = block_index(mesh, axes)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _gather_into(out, x, mesh.group(axes))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The sum over ``axes`` of ``x``, this rank's block of ``dim``; in
    float32, returned in ``x``'s dtype."""
    _, n = block_index(mesh, axes)
    xs = x.movedim(dim, 0).to(F32).contiguous()
    out = xs.new_empty((xs.shape[0] // n, *xs.shape[1:]))
    _scatter_into(out, xs, mesh.group(axes))
    return out.movedim(0, dim).to(x.dtype)


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """The sum (in float32) or max of ``x`` over ``axes``."""
    dist = _dist()
    if op == "sum":
        y = x.to(F32, copy=True, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=mesh.group(axes))
        return y.to(x.dtype)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return y


def local_block(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axes`` (a view)."""
    idx, n = block_index(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} over {axes}")
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _Gather(torch.autograd.Function):
    """All-gather on ``dim``.  Backward: ``"slice"`` (the consumers are
    replicas, so this rank's block of the gradient) or ``"sum"`` (the
    consumers' losses differ: reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes, bwd):
        ctx.args = (dim, mesh, axes, bwd)
        return all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, bwd = ctx.args
        if bwd == "slice":
            return local_block(g, dim, mesh, axes), None, None, None, None
        return reduce_scatter(g, dim, mesh, axes), None, None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``dim`` of a replicated tensor.  Backward:
    ``"gather"`` (replicas over ``axes``: every rank needs the whole
    gradient) or ``"pad"`` (this rank's share is its block's gradient,
    zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes, bwd):
        ctx.args = (dim, mesh, axes, bwd, x.shape)
        return local_block(x, dim, mesh, axes).clone()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, bwd, shape = ctx.args
        if bwd == "gather":
            return all_gather(g, dim, mesh, axes), None, None, None, None
        out = g.new_zeros(shape)
        local_block(out, dim, mesh, axes).copy_(g)
        return out, None, None, None, None


class _GatherParam(torch.autograd.Function):
    """A parameter's shard gathered whole.  Backward: this rank's block of
    each dim sharded over a non-batch axis, then the sum over the batch
    axes where the batch is split (reduce-scattered on a dim sharded over
    them, all-reduced over the others)."""

    @staticmethod
    def forward(ctx, x, spec, place):
        ctx.args = (spec, place)
        for d, e in enumerate(spec):
            if entry_axes(e):
                x = all_gather(x, d, place.mesh, entry_axes(e))
        return x

    @staticmethod
    def backward(ctx, g):
        spec, place = ctx.args
        mesh = place.mesh
        batch = set(place.batch_axes) if place.batch_sharded else set()
        # this rank's block over the other axes first (their ranks hold
        # replicas: no sum), then the sum over the batch axes
        for d, e in enumerate(spec):
            ax = entry_axes(e)
            if ax and not set(ax) <= batch:
                g = local_block(g, d, mesh, ax)
        summed = set()
        for d, e in enumerate(spec):
            ax = entry_axes(e)
            if ax and set(ax) <= batch:
                g = reduce_scatter(g, d, mesh, ax)
                summed |= set(ax)
        rest = tuple(a for a in place.batch_axes
                     if a in batch and a not in summed)
        if rest:
            g = all_reduce(g, mesh, rest)
        return g.contiguous(), None, None


class _Enter(torch.autograd.Function):
    """The input of a layer whose products are split over ``axes``:
    itself forward; backward, the sum of the ranks' gradients (each
    holds its block's share)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None


class _Leave(torch.autograd.Function):
    """The output of a layer whose products are split over ``axes``: the
    sum of the ranks' partial outputs; backward, the gradient itself
    (the ranks over ``axes`` hold replicas of what follows)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# --------------------------------------------------------------------------
# the active placement (the counterpart of JAX's mesh context)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """How a sharded step lays out its work on ``mesh``: the batch split
    over ``batch_axes`` (or replicated where ``batch_sharded`` is False),
    parameters as shards under ``param_specs`` (a spec tree), decode
    caches as shards under ``cache_spec(kind)`` (one block's specs, or
    no function outside decode), and the products of the layers that
    allow it split over ``tp_axis`` (tensor parallelism; None: none)."""
    mesh: Any
    batch_axes: Tuple[str, ...]
    batch_sharded: bool
    param_specs: Tree = None
    cache_spec: Optional[Callable] = None
    tp_axis: Optional[str] = None

    @property
    def batch_parts(self) -> int:
        return block_index(self.mesh, self.batch_axes)[1] \
            if self.batch_sharded else 1

    @property
    def batch_leader(self) -> bool:
        """Whether this rank's loss share carries the terms that are the
        same on every batch shard (the MoE's balance term, which has no
        gradient)."""
        return not self.batch_sharded or \
            block_index(self.mesh, self.batch_axes)[0] == 0

    def gather_param(self, x: torch.Tensor, spec,
                     keep: bool = False) -> torch.Tensor:
        """A parameter's shard gathered whole, or with ``keep`` gathered
        but over ``tp_axis`` (a tensor-parallel layer's own block)."""
        if keep:
            spec = tuple(None if set(entry_axes(e)) <= {self.tp_axis}
                         else e for e in spec)
        return _GatherParam.apply(x, tuple(spec), self)

    def tp_parts(self) -> int:
        return self.mesh.shape[self.tp_axis] if self.tp_axis else 1

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.mesh, (self.tp_axis,))

    def tp_leave(self, y: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(y, self.mesh, (self.tp_axis,))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A batch-split tensor's rows from every batch shard (dim 0);
        the backward sums the shards' gradients."""
        if not self.batch_sharded:
            return x
        return _Gather.apply(x, 0, self.mesh, self.batch_axes, "sum")

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor replicated over the batch axes."""
        if not self.batch_sharded:
            return x
        return _Split.apply(x, 0, self.mesh, self.batch_axes, "pad")

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the batch shards (float32), without a gradient."""
        if not self.batch_sharded:
            return x
        return all_reduce(x.detach(), self.mesh, self.batch_axes)

    def split(self, x, dim, axis, bwd):
        return _Split.apply(x, dim, self.mesh, (axis,), bwd)

    def gather(self, x, dim, axis, bwd):
        return _Gather.apply(x, dim, self.mesh, (axis,), bwd)


_ACTIVE: list = []


@contextlib.contextmanager
def use(place: Placement):
    """Run the model code under ``place``."""
    _ACTIVE.append(place)
    try:
        yield place
    finally:
        _ACTIVE.pop()


def active() -> Optional[Placement]:
    return _ACTIVE[-1] if _ACTIVE else None


# --------------------------------------------------------------------------
# named shardings (NamedSharding's counterpart)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    mesh: Any
    spec: P

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh.shape)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor (a contiguous copy on the
        mesh's device)."""
        x = full
        for d, e in enumerate(self.spec):
            if entry_axes(e):
                x = local_block(x, d, self.mesh, entry_axes(e))
        return x.to(self.mesh.local_device, copy=True).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's shard (``local`` itself
        where the spec splits nothing)."""
        x = local
        for d, e in enumerate(self.spec):
            if entry_axes(e):
                x = all_gather(x, d, self.mesh, entry_axes(e))
        return x


def shard_tree(tree: Tree, shardings: Tree) -> Tree:
    from .params import tree_map
    return tree_map(lambda t, s: s.local(t), tree, shardings)


def gather_tree(tree: Tree, shardings: Tree) -> Tree:
    from .params import tree_map
    return tree_map(lambda t, s: s.gather(t), tree, shardings)


def global_sumsq(tree: Tree, shardings: Tree) -> list:
    """Each leaf's float32 sum of squares over the whole mesh, every
    element counted once: a shard's own sum is counted by the ranks at
    coordinate 0 of each axis the leaf is not sharded on, then summed
    over the mesh in one all-reduce."""
    from .params import tree_leaves
    leaves, shards = tree_leaves(tree), tree_leaves(shardings)
    if not leaves:
        return []
    mesh = shards[0].mesh
    parts = []
    for g, s in zip(leaves, shards):
        used = {a for e in s.spec for a in entry_axes(e)}
        lead = all(mesh.coordinate(a) == 0 for a in mesh.axis_names
                   if a not in used)
        sq = torch.square(torch.linalg.vector_norm(g, dtype=F32))
        parts.append(sq if lead else torch.zeros_like(sq))
    total = torch.stack(parts)
    _dist().all_reduce(total, group=mesh.group(mesh.axis_names))
    return list(total.unbind())
