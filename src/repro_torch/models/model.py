"""Model assembly: forward / loss / prefill / decode for all 10 archs.

One code path serves every family; heterogeneous stacks run as repeated
super-blocks (pattern units, whose parameters carry a leading unit axis)
with optional tail/prefix layers.  Decode threads a per-layer state tree
(KV caches for attention kinds, recurrent states for ssm/hybrid kinds)
through the same block dispatch, and writes it in place: a cache is
allocated once (``init_cache``) and every ``decode_step`` updates it.

Under an active ``sharding.Placement`` (the sharded steps of
``train/loop.py``) the parameters and caches are this rank's shards and
the batch this rank's rows: each parameter is gathered where it runs (a
stacked unit's inside its remat checkpoint), the loss is this rank's
share of the global mean, and a decode cache's positions stay split over
"model".
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import resolve_device

from .config import ModelConfig
from .griffin import rglru_block
from .layers import attention_block, ffn_block, linear, rms_norm
from .moe import _ep_possible, moe_ffn, shared_ffn, shuffle_perm
from .params import slstm_inner, tree_map
from .sharding import active, all_gather, entry_axes, local_block, \
    resolve_spec
from .xlstm import mlstm_block, slstm_block

F32 = torch.float32
Tree = Any

#: The batch axes: the step's input is split over those of them in the
#: mesh, so the reference's batch constraints on activations hold from
#: the input on.  Dense activations stay whole over "model" (the
#: reference's constraint of the logits' vocab dim over "model" has no
#: counterpart: it would split the cross entropy's sums).
_BATCH = ("pod", "data")


def _resolved(x: torch.Tensor, axes):
    """(placement, spec) of the reference's rule for ``x`` under the
    active placement: axes the mesh lacks, or that do not divide a dim,
    are dropped; so are batch axes where the batch is not split over
    them (their ranks then hold replicas of one loss)."""
    place = active()
    if place is None:
        return None, None
    shape = {a: n for a, n in place.mesh.shape.items()
             if place.batch_sharded or a not in place.batch_axes}
    return place, resolve_spec(x.shape, axes, shape)


def _maybe_constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """This rank's block of ``x`` (whole on every rank) under the
    reference's resolution of ``axes`` (one mesh axis, a tuple of axes,
    or None per dim); ``x`` itself outside a placement.  The backward
    gathers the gradient over "model" (whose ranks hold replicas) and
    zero-pads it over a batch axis (whose ranks' losses differ)."""
    place, spec = _resolved(x, axes)
    if place is None:
        return x
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            x = place.split(x, d, a,
                            "pad" if a in place.batch_axes else "gather")
    return x


def _maybe_release(x: torch.Tensor, shape, *axes) -> torch.Tensor:
    """The inverse of ``_maybe_constrain`` for a tensor whose whole shape
    is ``shape``: every rank's block gathered (the backward sums the
    shares over a batch axis, and takes this rank's block over
    "model")."""
    place, spec = _resolved(torch.empty(shape, device="meta"), axes)
    if place is None:
        return x
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            x = place.gather(x, d, a,
                             "sum" if a in place.batch_axes else "slice")
    return x


_ATTN_TP = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_FFN_TP = ("w_gate", "w_up", "w_down")
_SHARED_TP = ("s_gate", "s_up", "s_down")


def tp_split(cfg: ModelConfig, kind: str, block, parts: int) -> tuple:
    """The names of a block's parameters whose products split over a
    tensor-parallel axis of ``parts`` ranks (Megatron style, each rank
    its block of heads or columns): attention's projections where the
    axis divides the heads and the KV heads, a dense FFN's where it
    divides d_ff, the shared experts' where it divides their width.
    ``block``: the block's parameter names."""
    out = ()
    if kind in _ATTN_KINDS and cfg.num_heads % parts == 0 and \
            cfg.num_kv_heads % parts == 0:
        out += _ATTN_TP
    if "router" in block:
        m = cfg.moe
        if m.num_shared and (m.d_expert // m.expert_split * m.num_shared) \
                % parts == 0:
            out += _SHARED_TP
    elif "w_gate" in block and cfg.d_ff % parts == 0:
        out += _FFN_TP
    return tuple(k for k in out if k in block)


_EXPERT_W = ("w_gate", "w_up", "w_down")


def _kept(cfg, place, kind, block, specs) -> tuple:
    """The names of a block's parameters gathered but over the model
    axis, each rank keeping its block there: ``tp_split``'s, and, expert
    parallel, the expert weights where they are stored with their
    experts split over the axis (this rank's experts).  None outside a
    placement.  ``specs``: the block's (unstacked) specs."""
    if place is None or place.tp_axis is None:
        return ()
    out = tp_split(cfg, kind, block, place.tp_parts())
    if "router" in block and \
            _ep_possible(cfg.moe.num_experts * cfg.moe.expert_split) and \
            specs["w_gate"][0] == place.tp_axis:
        out += _EXPERT_W
    return out


def _gather_block(cfg, place, kind, p, specs):
    kept = _kept(cfg, place, kind, p, specs)
    return {k: place.gather_param(v, specs[k], k in kept)
            for k, v in p.items()}


def _gathered(params: Tree, cfg: ModelConfig) -> Tree:
    """Under a placement: every parameter outside the stacked units
    gathered (those are gathered a unit at a time in ``_apply_stack``),
    whole but for the blocks kept over "model" (``_kept``); ``params``
    itself otherwise."""
    place = active()
    if place is None:
        return params
    out = dict(params)
    for k in ("embed", "final_norm", "lm_head"):
        if k in params:
            out[k] = place.gather_param(params[k], place.param_specs[k])
    for group in ("prefix", "tail"):
        out[group] = {name: _gather_block(
            cfg, place, name.split("_", 1)[1], p,
            place.param_specs[group][name])
            for name, p in params[group].items()}
    return out


# --------------------------------------------------------------------------
# single block
# --------------------------------------------------------------------------

def _ffn_params(p):
    return {k: p[k] for k in ("w_gate", "w_up", "w_down")}


def _identity(x):
    return x


def _tp(p, name: str, width: int):
    """(enter, leave) of a layer whose ``name`` weight is this rank's
    tensor-parallel block (narrower than ``width``): the input's
    gradient summed over the axis, the partial outputs summed; identities
    where the weight is whole."""
    place = active()
    if place is None or p[name].shape[-1] == width:
        return _identity, _identity
    return place.tp_enter, place.tp_leave


def _ffn(p, x, cfg: ModelConfig):
    enter, leave = _tp(p, "w_gate", cfg.d_ff)
    return leave(ffn_block(_ffn_params(p), enter(rms_norm(x, p["norm2"])),
                           cfg.activation))


def block_apply(kind: str, p: Tree, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, cache=None, cache_len=None,
                decode: bool = False, prefix_len: int = 0,
                perm: Optional[torch.Tensor] = None, seq_shard=None):
    """Returns (x, new_cache, aux_loss).  ``perm``: the Valiant shuffle's
    token permutation for a MoE block; ``seq_shard``: (mesh, axes) over
    which an attention block's cache positions are split."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    if kind in ("attn", "local_attn", "moe"):
        window = cfg.attn_window if kind == "local_attn" else None
        enter, leave = _tp(p, "wq", cfg.q_dim)
        if cfg.qk_norm:
            # whole on every rank but applied to its heads only: the
            # gradient is summed as the input's is
            p = dict(p, q_norm=enter(p["q_norm"]), k_norm=enter(p["k_norm"]))
        place = active()
        h, new_cache = attention_block(
            p, enter(rms_norm(x, p["norm1"])), cfg, positions,
            window=window, prefix_len=prefix_len, kv_cache=cache,
            cache_len=cache_len, seq_shard=seq_shard, out_sum=leave,
            head_shard=None if enter is _identity else
            (place.mesh, (place.tp_axis,)))
        x = x + h
        if kind == "moe" and "router" in p:
            y, aux = moe_ffn(p, rms_norm(x, p["norm2"]), cfg.moe,
                             cfg.activation, perm=perm)
            if "s_gate" in p:
                m = cfg.moe
                enter, leave = _tp(
                    p, "s_gate", m.d_expert // m.expert_split * m.num_shared)
                y = y + leave(shared_ffn(
                    {"w_gate": p["s_gate"], "w_up": p["s_up"],
                     "w_down": p["s_down"]},
                    enter(rms_norm(x, p["norm2"])), cfg.activation))
            x = x + y
        elif "w_gate" in p:
            x = x + _ffn(p, x, cfg)
    elif kind == "mlstm":
        h, new_cache = mlstm_block(p, rms_norm(x, p["norm1"]), cfg,
                                   state=cache, decode=decode)
        x = x + h
    elif kind == "slstm":
        h, new_cache = slstm_block(p, rms_norm(x, p["norm1"]), cfg,
                                   state=cache, decode=decode)
        x = x + h
    elif kind == "rglru":
        h, new_cache = rglru_block(p, rms_norm(x, p["norm1"]), cfg,
                                   state=cache, decode=decode)
        x = x + h
        if "w_gate" in p and "norm2" in p:
            x = x + _ffn(p, x, cfg)
    else:
        raise ValueError(kind)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# cache construction
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _block_cache_shape(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    """Abstract cache for one block (no leading unit axis), as ``meta``
    tensors: KV caches bf16, recurrent states f32, the conv state bf16."""
    bf = torch.bfloat16
    if kind in ("attn", "moe"):
        c = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return (_meta(c, bf), _meta(c, bf))
    if kind == "local_attn":
        w = min(cfg.attn_window or max_len, max_len)
        c = (batch, w, cfg.num_kv_heads, cfg.head_dim)
        return (_meta(c, bf), _meta(c, bf))
    if kind == "mlstm":
        inner = int(cfg.d_model * cfg.lstm_proj_factor)
        Dk = inner // cfg.num_heads
        return (_meta((batch, cfg.num_heads, Dk, Dk), F32),
                _meta((batch, cfg.num_heads, Dk), F32))
    if kind == "slstm":
        Dh = slstm_inner(cfg) // cfg.num_heads
        return tuple(_meta((batch, cfg.num_heads, Dh), F32) for _ in range(4))
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        return (_meta((batch, w), F32),
                _meta((batch, cfg.conv_width - 1, w), bf))
    raise ValueError(kind)


def _layout(cfg: ModelConfig):
    """(pattern unit, number of units, tail kinds)."""
    unit = cfg.pattern()
    n_scan = cfg.num_layers - cfg.dense_first_layers
    return unit, n_scan // len(unit), unit[: n_scan % len(unit)]


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Tree:
    unit, n_units, tail_kinds = _layout(cfg)

    def stack(t):
        return _meta((n_units, *t.shape), t.dtype)

    return {
        "stack": {f"u{j}_{k}": tree_map(
            stack, _block_cache_shape(cfg, k, batch, max_len))
                  for j, k in enumerate(unit)},
        "tail": {f"t{j}_{k}": _block_cache_shape(cfg, k, batch, max_len)
                 for j, k in enumerate(tail_kinds)},
        "prefix": {f"p{j}_{unit[0]}": _block_cache_shape(cfg, unit[0], batch,
                                                         max_len)
                   for j in range(cfg.dense_first_layers)},
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Tree:
    dev = resolve_device(device)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                    abstract_cache(cfg, batch, max_len))


# --------------------------------------------------------------------------
# stack traversal
# --------------------------------------------------------------------------

_ATTN_KINDS = ("attn", "local_attn", "moe")


def _model_dims(place, spec):
    """(dim, axes) of a cache leaf's dims split over non-batch axes (its
    batch dim is this rank's rows already)."""
    for d, e in enumerate(spec):
        ax = tuple(a for a in entry_axes(e) if a not in place.batch_axes)
        if ax:
            yield d, ax


def _state_whole(place, t, spec):
    for d, ax in _model_dims(place, spec):
        t = all_gather(t, d, place.mesh, ax)
    return t


def _state_block(place, t, spec):
    for d, ax in _model_dims(place, spec):
        t = local_block(t, d, place.mesh, ax)
    return t


def _store(cache: tuple, new: tuple) -> None:
    """Write a block's new state into its cache views (attention blocks
    have already written theirs in place and hand the views back)."""
    for dst, src in zip(cache, new):
        if src is not dst:
            dst.copy_(src)


def _shuffle_perm(cfg: ModelConfig, x: torch.Tensor,
                  generator: Optional[torch.Generator]):
    """The Valiant shuffle's token permutation, drawn once a pass and
    shared by every MoE layer, as the reference's one key is.  Drawn
    outside the checkpointed units, so that their recompute sees it too
    (checkpointing restores the default RNG states, never a generator's).
    None where the shuffle is off."""
    if cfg.moe is None or not cfg.moe.valiant_shuffle:
        return None
    place = active()
    rows = x.shape[0] * (1 if place is None else place.batch_parts)
    return shuffle_perm(rows * x.shape[1], x.device, generator)


def _apply_stack(params: Tree, x: torch.Tensor, cfg: ModelConfig,
                 positions, *, caches=None, cache_len=None, decode=False,
                 prefix_len=0, generator=None, remat=False):
    """Run prefix layers, the stacked super-block units, then tail layers.
    Caches, where given, are updated in place.  ``remat`` recomputes each
    stacked unit on the backward pass instead of saving its activations
    (prefix and tail layers are not checkpointed, as in the reference).
    Returns (x, aux_loss)."""
    unit, _, tail_kinds = _layout(cfg)
    perm = _shuffle_perm(cfg, x, generator)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    place = active()

    def run(kind, p, x, cache):
        specs = None if place is None or cache is None else \
            place.cache_spec(kind)
        state, seq = cache, None
        if specs is not None and kind in _ATTN_KINDS:
            # the cache's positions split over "model": sequence-parallel
            # decode attention
            ax = entry_axes(specs[0][1])
            seq = (place.mesh, ax) if ax else None
        elif specs is not None:
            # a recurrent state split over "model": whole for the step,
            # then this rank's block stored
            state = tuple(_state_whole(place, t, sp)
                          for t, sp in zip(cache, specs))
        x, nc, aux = block_apply(kind, p, x, cfg, positions, cache=state,
                                 cache_len=cache_len, decode=decode,
                                 prefix_len=prefix_len, perm=perm,
                                 seq_shard=seq)
        if cache is not None:
            if state is not cache:
                nc = tuple(_state_block(place, t, sp)
                           for t, sp in zip(nc, specs))
            _store(cache, nc)
        return x, aux

    def get_cache(group, name, u=None):
        if caches is None:
            return None
        c = caches[group][name]
        return c if u is None else tuple(t[u] for t in c)

    for j in range(cfg.dense_first_layers):
        name = f"p{j}_{unit[0]}"
        x, aux = run(unit[0], params["prefix"][name], x,
                     get_cache("prefix", name))
        aux_total = aux_total + aux
    names = [f"u{j}_{kind}" for j, kind in enumerate(unit)]
    keys = [(n, k) for n in names for k in sorted(params["stack"][n])]

    specs = {n: {k: v[1:] for k, v in place.param_specs["stack"][n].items()}
             for n in names} if place is not None else {}
    kept = {n: _kept(cfg, place, kind, params["stack"][n], specs.get(n))
            for n, kind in zip(names, unit)}

    def unit_fn(u, x, *leaves):
        p = {n: {} for n in names}
        for (n, k), t in zip(keys, leaves):
            if place is not None:
                t = place.gather_param(t, specs[n][k], k in kept[n])
            p[n][k] = t
        aux = None
        for n, kind in zip(names, unit):
            x, a = run(kind, p[n], x, get_cache("stack", n, u))
            aux = a if aux is None else aux + a
        return x, aux

    # One unbind per stacked leaf: its backward stacks the units'
    # gradients once, where indexing v[u] would add a zero-filled
    # gradient of the whole stacked leaf for every unit.
    for u, leaves in enumerate(zip(*(torch.unbind(params["stack"][n][k])
                                     for n, k in keys))):
        if remat and caches is None:
            x, aux = checkpoint(unit_fn, u, x, *leaves, use_reentrant=False)
        else:
            x, aux = unit_fn(u, x, *leaves)
        aux_total = aux_total + aux
    for j, kind in enumerate(tail_kinds):
        name = f"t{j}_{kind}"
        x, aux = run(kind, params["tail"][name], x, get_cache("tail", name))
        aux_total = aux_total + aux
    return x, aux_total


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def embed_scale(cfg: ModelConfig) -> float:
    """sqrt(d_model) rounded to bf16, as the reference applies it (50.5,
    not 50.596, at d_model 2560)."""
    return float(torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16))


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def embed_inputs(params: Tree, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]):
    """Family-specific input embedding. Returns (x, positions, prefix_len)."""
    bf = torch.bfloat16
    if cfg.frontend == "encodec_stub":
        x = batch["frames"].to(bf)                          # (B, S, d)
        B, S, _ = x.shape
        return x, _positions(B, S, x.device), 0
    if cfg.frontend == "siglip_stub":
        img = batch["image_embeds"].to(bf)                  # (B, P, d)
        tok = params["embed"][batch["tokens"].long()]
        x = torch.cat([img, tok.to(bf)], dim=1) * embed_scale(cfg)
        B, S, _ = x.shape
        return x, _positions(B, S, x.device), cfg.prefix_len
    tok = params["embed"][batch["tokens"].long()]
    x = tok.to(bf) * embed_scale(cfg)
    B, S = batch["tokens"].shape
    return x, _positions(B, S, x.device), 0


def logits_from_hidden(params: Tree, cfg: ModelConfig, x: torch.Tensor):
    """f32 logits of the head product, which runs (and rounds) in the
    parameters' dtype, bf16 for ``init_params``."""
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(x, head).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.num_codebooks > 1:
        B, S, _ = logits.shape
        logits = logits.reshape(B, S, cfg.num_codebooks, cfg.vocab_size)
    return logits


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, generator: Optional[torch.Generator] = None,
            remat: bool = False, scan_unroll=1):
    """(logits, aux).  ``generator`` draws the Valiant shuffle's
    permutation; ``remat`` checkpoints each stacked pattern unit
    (``torch.utils.checkpoint``).  ``scan_unroll`` only steers XLA in the
    reference and is ignored."""
    params = _gathered(params, cfg)
    x, positions, prefix_len = embed_inputs(params, cfg, batch)
    x, aux = _apply_stack(params, x, cfg, positions, prefix_len=prefix_len,
                          generator=generator, remat=remat)
    return logits_from_hidden(params, cfg, x), aux


def loss_fn(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, generator: Optional[torch.Generator] = None,
            remat: bool = False, scan_unroll=1):
    """(loss + aux, {"ce", "aux"}): masked mean cross entropy (labels < 0
    are masked) plus the MoE aux loss; differentiable with autograd."""
    logits, aux = forward(params, cfg, batch, generator=generator,
                          remat=remat)
    labels = batch["labels"].long()
    if cfg.frontend == "siglip_stub":
        logits = logits[:, cfg.prefix_len:]
    lse = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    pick = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    nll = lse - pick
    mask = (labels >= 0).to(F32)
    count = mask.sum()
    place = active()
    if place is not None:
        # this rank's share of the global mean (the MoE's aux loss is a
        # share already)
        count = place.batch_sum(count)
    loss = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
    return loss + aux, {"ce": loss, "aux": aux}


def prefill(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, scan_unroll=1):
    """Prefill forward: logits for the LAST position only (the next-token
    sample)."""
    params = _gathered(params, cfg)
    x, positions, prefix_len = embed_inputs(params, cfg, batch)
    x, _ = _apply_stack(params, x, cfg, positions, prefix_len=prefix_len)
    return logits_from_hidden(params, cfg, x[:, -1:])


def decode_step(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Tree, pos: int, *, scan_unroll=1):
    """One decode step.  tokens: (B, 1) int; pos: the current length (an
    int).  Returns (logits (B, 1, V[*K]), caches), the caches updated in
    place."""
    pos = int(pos)
    params = _gathered(params, cfg)
    tok = params["embed"][tokens.long()]
    x = tok.to(torch.bfloat16) * embed_scale(cfg)
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    # local_attn ring buffers index at pos % window
    x, _ = _apply_stack(params, x, cfg, positions, caches=caches,
                        cache_len=pos, decode=True)
    return logits_from_hidden(params, cfg, x), caches
