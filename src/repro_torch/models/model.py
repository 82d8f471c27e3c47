"""Model assembly: forward / loss / prefill / decode for all 10 archs.

One code path serves every family; heterogeneous stacks run as repeated
super-blocks (pattern units, whose parameters carry a leading unit axis)
with optional tail/prefix layers.  Decode threads a per-layer state tree
(KV caches for attention kinds, recurrent states for ssm/hybrid kinds)
through the same block dispatch, and writes it in place: a cache is
allocated once (``init_cache``) and every ``decode_step`` updates it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import resolve_device

from .config import ModelConfig
from .griffin import rglru_block
from .layers import attention_block, ffn_block, linear, rms_norm
from .moe import moe_ffn, shared_ffn, shuffle_perm
from .params import slstm_inner, tree_map
from .xlstm import mlstm_block, slstm_block

F32 = torch.float32
Tree = Any


# --------------------------------------------------------------------------
# single block
# --------------------------------------------------------------------------

def _ffn_params(p):
    return {k: p[k] for k in ("w_gate", "w_up", "w_down")}


def block_apply(kind: str, p: Tree, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, cache=None, cache_len=None,
                decode: bool = False, prefix_len: int = 0,
                perm: Optional[torch.Tensor] = None):
    """Returns (x, new_cache, aux_loss).  ``perm``: the Valiant shuffle's
    token permutation for a MoE block."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    if kind in ("attn", "local_attn", "moe"):
        window = cfg.attn_window if kind == "local_attn" else None
        h, new_cache = attention_block(
            p, rms_norm(x, p["norm1"]), cfg, positions, window=window,
            prefix_len=prefix_len, kv_cache=cache, cache_len=cache_len)
        x = x + h
        if kind == "moe" and "router" in p:
            y, aux = moe_ffn(p, rms_norm(x, p["norm2"]), cfg.moe,
                             cfg.activation, perm=perm)
            if "s_gate" in p:
                y = y + shared_ffn(
                    {"w_gate": p["s_gate"], "w_up": p["s_up"],
                     "w_down": p["s_down"]},
                    rms_norm(x, p["norm2"]), cfg.activation)
            x = x + y
        elif "w_gate" in p:
            x = x + ffn_block(_ffn_params(p), rms_norm(x, p["norm2"]),
                              cfg.activation)
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
            x = x + ffn_block(_ffn_params(p), rms_norm(x, p["norm2"]),
                              cfg.activation)
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
    return shuffle_perm(x.shape[0] * x.shape[1], x.device, generator)


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

    def run(kind, p, x, cache):
        x, nc, aux = block_apply(kind, p, x, cfg, positions, cache=cache,
                                 cache_len=cache_len, decode=decode,
                                 prefix_len=prefix_len, perm=perm)
        if cache is not None:
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

    def unit_fn(u, x, *leaves):
        p = {n: {} for n in names}
        for (n, k), t in zip(keys, leaves):
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
    loss = torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return loss + aux, {"ce": loss, "aux": aux}


def prefill(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, scan_unroll=1):
    """Prefill forward: logits for the LAST position only (the next-token
    sample)."""
    x, positions, prefix_len = embed_inputs(params, cfg, batch)
    x, _ = _apply_stack(params, x, cfg, positions, prefix_len=prefix_len)
    return logits_from_hidden(params, cfg, x[:, -1:])


def decode_step(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Tree, pos: int, *, scan_unroll=1):
    """One decode step.  tokens: (B, 1) int; pos: the current length (an
    int).  Returns (logits (B, 1, V[*K]), caches), the caches updated in
    place."""
    pos = int(pos)
    tok = params["embed"][tokens.long()]
    x = tok.to(torch.bfloat16) * embed_scale(cfg)
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    # local_attn ring buffers index at pos % window
    x, _ = _apply_stack(params, x, cfg, positions, caches=caches,
                        cache_len=pos, decode=True)
    return logits_from_hidden(params, cfg, x), caches
