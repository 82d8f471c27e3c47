"""Parameter construction: shapes, init, counting, and sharding specs.

The parameter tree mirrors the stacked layout of ``repro.models.params``::

    params = {
      "embed": (V, d),
      "stack": { u{j}_{kind}: {block params with leading n_units axis} },
      "tail":  { t{j}_{kind}: per-layer block params (pattern remainder) },
      "prefix":{ p{j}_{kind}: dense-first layers for MoE archs },
      "final_norm": (d,), "lm_head": (d, V or K*V),
    }

Each leaf of ``model_shape_tree`` is ``(shape, spec)``, where ``spec`` is a
tuple of logical axis names (``"tp"``: model axis, ``"fsdp"``: data axis,
``None``: replicated), one per dim; ``param_specs`` resolves them to mesh
axes (``sharding.P``).  Shapes are produced on the ``meta`` device
(``abstract_params``) and concretely (``init_params``) from a
``torch.Generator``; ``from_reference`` carries the reference's numpy
tree across.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

from .config import ModelConfig

Tree = Any
PDTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# per-block shape tables: dict name -> (shape, spec)
# spec axes use logical names: "fsdp" -> data axis, "tp" -> model axis
# --------------------------------------------------------------------------

def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "norm1": ((d,), ()),
        "wq": ((d, qd), ("fsdp", "tp")),
        "wk": ((d, kvd), ("fsdp", "tp")),
        "wv": ((d, kvd), ("fsdp", "tp")),
        "wo": ((qd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        s |= {"bq": ((qd,), ("tp",)), "bk": ((kvd,), ("tp",)),
              "bv": ((kvd,), ("tp",))}
    if cfg.qk_norm:
        s |= {"q_norm": ((cfg.head_dim,), ()),
              "k_norm": ((cfg.head_dim,), ())}
    return s


def _ffn_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, tuple]:
    d = cfg.d_model
    return {
        "norm2": ((d,), ()),
        "w_gate": ((d, d_ff), ("fsdp", "tp")),
        "w_up": ((d, d_ff), ("fsdp", "tp")),
        "w_down": ((d_ff, d), ("tp", "fsdp")),
    }


def _moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    m = cfg.moe
    E, f = m.num_experts * m.expert_split, m.d_expert // m.expert_split
    # Expert-parallel over tp when E divides the axis (deepseek 64e, grok
    # 8e x split 2), with the d-dim FSDP-sharded over data; otherwise TP
    # inside each expert (E replicated, f sharded).
    if E % 16 == 0:
        w_specs = (("tp", "fsdp", None), ("tp", "fsdp", None),
                   ("tp", None, "fsdp"))
    else:
        w_specs = ((None, "fsdp", "tp"), (None, "fsdp", "tp"),
                   (None, "tp", "fsdp"))
    s = {
        "norm2": ((d,), ()),
        "router": ((d, E), ()),
        "w_gate": ((E, d, f), w_specs[0]),
        "w_up": ((E, d, f), w_specs[1]),
        "w_down": ((E, f, d), w_specs[2]),
    }
    if m.num_shared:
        fs = f * m.num_shared
        s |= {"s_gate": ((d, fs), ("fsdp", "tp")),
              "s_up": ((d, fs), ("fsdp", "tp")),
              "s_down": ((fs, d), ("tp", "fsdp"))}
    return s


def _mlstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    inner = int(d * cfg.lstm_proj_factor)
    H = cfg.num_heads
    return {
        "norm1": ((d,), ()),
        "w_qkv": ((d, 4 * inner), ("fsdp", "tp")),
        "w_gates": ((d, 2 * H), ()),
        "w_out": ((inner, d), ("tp", "fsdp")),
    }


def slstm_inner(cfg: ModelConfig) -> int:
    """sLSTM up-projection width: ~4/3 d, rounded so heads AND a 16-wide
    model axis divide it."""
    unit = cfg.num_heads * 16
    return ((int(cfg.d_model * 4 / 3) + unit - 1) // unit) * unit


def _slstm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    inner = slstm_inner(cfg)
    Dh = inner // cfg.num_heads
    return {
        "norm1": ((d,), ()),
        "w_in": ((d, 4 * inner), ("fsdp", "tp")),
        "r_kernel": ((cfg.num_heads, Dh, 4 * Dh), ()),
        "w_out": ((inner, d), ("tp", "fsdp")),
    }


def _rglru_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "norm1": ((d,), ()),
        "w_gelu_gate": ((d, w), ("fsdp", "tp")),
        "w_in": ((d, w), ("fsdp", "tp")),
        "conv_kernel": ((cfg.conv_width, w), (None, "tp")),
        "w_rgate": ((w, w), ("fsdp", "tp")),
        "w_igate": ((w, w), ("fsdp", "tp")),
        "lam": ((w,), ("tp",)),
        "w_out": ((w, d), ("tp", "fsdp")),
    }


def block_shapes(cfg: ModelConfig, kind: str, *, dense_ffn: bool = False
                 ) -> Dict[str, tuple]:
    if kind in ("attn", "local_attn"):
        s = _attn_shapes(cfg)
        if cfg.d_ff:
            s |= _ffn_shapes(cfg, cfg.d_ff)
        return s
    if kind == "moe":
        s = _attn_shapes(cfg)
        s |= _ffn_shapes(cfg, cfg.d_ff) if dense_ffn else _moe_shapes(cfg)
        return s
    if kind == "mlstm":
        return _mlstm_shapes(cfg)
    if kind == "slstm":
        return _slstm_shapes(cfg)
    if kind == "rglru":
        s = _rglru_shapes(cfg)
        if cfg.d_ff:
            s |= _ffn_shapes(cfg, cfg.d_ff)
        return s
    raise ValueError(f"unknown block kind {kind!r}")


def model_shape_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """Full (shape, spec) tree for the model."""
    d, V = cfg.d_model, cfg.vocab_size
    unit = cfg.pattern()
    n_scan_layers = cfg.num_layers - cfg.dense_first_layers
    n_units = n_scan_layers // len(unit)
    tail_kinds = unit[: n_scan_layers % len(unit)]

    def stacked(shapes: Dict[str, tuple], n: int):
        return {k: ((n, *shp), (None,) + tuple(sp) if n else sp)
                for k, (shp, sp) in shapes.items()}

    tree: Dict[str, Any] = {
        "embed": ((V, d), ("tp", None)),
        "final_norm": ((d,), ()),
    }
    head_out = V * cfg.num_codebooks
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, head_out), (None, "tp"))
    tree["stack"] = {
        f"u{j}_{kind}": stacked(block_shapes(cfg, kind), n_units)
        for j, kind in enumerate(unit)
    }
    tree["tail"] = {
        f"t{j}_{kind}": block_shapes(cfg, kind)
        for j, kind in enumerate(tail_kinds)
    }
    tree["prefix"] = {
        f"p{j}_{unit[0]}": block_shapes(cfg, unit[0], dense_ffn=True)
        for j in range(cfg.dense_first_layers)
    }
    return tree


# --------------------------------------------------------------------------
# tree helpers (nested dicts; leaves are (shape, spec) pairs or tensors)
# --------------------------------------------------------------------------

def _is_shape_leaf(t) -> bool:
    return isinstance(t, tuple) and isinstance(t[0], tuple)


def _map_leaves(fn: Callable, tree, path=()):
    """``fn(path, (shape, spec))`` on every leaf of a shape tree, dict keys
    in sorted order (the order ``jax.tree.flatten`` visits them)."""
    if _is_shape_leaf(tree):
        return fn(path, tree)
    return {k: _map_leaves(fn, tree[k], path + (k,)) for k in sorted(tree)}


def _map_shapes(fn: Callable, tree):
    """``fn(path, shape)`` on every leaf of a shape tree."""
    return _map_leaves(lambda path, t: fn(path, t[0]), tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` on every tensor of a nested dict / tuple / NamedTuple tree,
    with the matching leaves of ``rest`` (trees of the same structure) as
    further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Tree:
    """A tree of ``like``'s structure holding ``leaves``, taken in
    ``tree_leaves``'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            out = [build(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
        return next(it)
    return build(like)


def abstract_params(cfg: ModelConfig) -> Tree:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    return _map_shapes(
        lambda _, shp: torch.empty(shp, dtype=PDTYPE, device="meta"),
        model_shape_tree(cfg))


def param_specs(cfg: ModelConfig, *, fsdp: bool, data_axis="data",
                model_axis="model") -> Tree:
    """The spec tree with the logical axes resolved to mesh axes: "tp" to
    ``model_axis``, "fsdp" to ``data_axis`` where ``fsdp`` (else
    replicated)."""
    from .sharding import P

    def resolve(path, t):
        out = []
        for ax in t[1]:
            if ax == "tp":
                out.append(model_axis)
            elif ax == "fsdp":
                out.append(data_axis if fsdp else None)
            else:
                out.append(ax)
        return P(*out)
    return _map_leaves(resolve, model_shape_tree(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", keep: Callable = None) -> Tree:
    """Random parameters drawn from ``generator`` (which must live on
    ``device``): N(0, 1/fan_in) in float32, each leaf then cast to bf16.
    As in the reference, every leaf is bf16, ``lam`` included.  A stacked
    leaf (under "stack") is drawn a unit at a time, so that one unit's
    float32 draw at most is on the device.  ``keep`` (``keep(path,
    leaf)`` -> what to hold of it, e.g. a rank's shard; for a stacked
    leaf, of one unit's) is applied to each draw before the next."""
    dev = resolve_device(device)
    if keep is None:
        def keep(path, w):
            return w

    def normal(shp, scale):
        w = torch.randn(shp, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(scale).to(PDTYPE)

    def draw(path, shp):
        fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
        if path[0] != "stack" or not shp[0]:
            return keep(path, normal(shp, scale))
        out = None
        for u in range(shp[0]):
            w = keep(path, normal(shp[1:], scale))
            if out is None:
                out = w.new_empty((shp[0], *w.shape))
            out[u] = w
        return out

    return _map_shapes(draw, model_shape_tree(cfg))


_FROM_NUMPY = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def from_reference(cfg: ModelConfig, tree: Tree, *, device="cuda") -> Tree:
    """The reference's parameter tree (numpy leaves, e.g. the
    ``np.asarray`` of each ``repro.models.params.init_params`` leaf) as the
    port's: the same keys, values and dtypes.  A bf16 leaf (an ml_dtypes
    array) goes through float32, which holds every bf16 value exactly."""
    dev = resolve_device(device)

    def carry(path, shp):
        node = tree
        for k in path:
            node = node[k]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(shp):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                             f"expected {shp}")
        dtype = _FROM_NUMPY.get(a.dtype.name)
        if dtype is None:
            raise TypeError(f"{'/'.join(path)}: dtype {a.dtype} is neither "
                            f"bfloat16 nor float32")
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t.to(device=dev, dtype=dtype)

    return _map_shapes(carry, model_shape_tree(cfg))


def count_params_config(cfg: ModelConfig, *, active_only: bool = False) -> int:
    """Analytic parameter count; ``active_only`` counts top-k experts only."""
    total = 0
    E_eff = (cfg.moe.num_experts * cfg.moe.expert_split
             if cfg.moe is not None else 0)

    def visit(path, shp):
        nonlocal total
        n = int(np.prod(shp))
        if active_only and cfg.moe is not None and path and \
                path[-1] in ("w_gate", "w_up", "w_down") and len(shp) >= 3 \
                and shp[-3] == E_eff:
            n = n * (cfg.moe.top_k + cfg.moe.num_shared) // cfg.moe.num_experts
        total += n

    _map_shapes(visit, model_shape_tree(cfg))
    return total
