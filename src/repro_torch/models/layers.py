"""Shared neural-net layers: norms, rope, attention, FFN.

All functions are pure (params explicit), bf16 activations with f32
reductions, as in ``repro.models.layers``.  Where the reference's jnp
einsum mixes dtypes, the operands are promoted the way jnp promotes them
(``bf16 x f32 -> f32``) before the product.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .sharding import all_gather, all_reduce, block_index, local_block

F32 = torch.float32

# The reference unrolls its inner scans for XLA's cost analysis when this
# is set; the port runs plain loops, so it is accepted and has no effect.
ANALYSIS_UNROLL = False


def promote(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their common dtype, as jnp promotes a product's
    operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,df->...f", x, w)`` with jnp's dtype promotion."""
    return torch.matmul(*promote(x, w))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Rotates halves (the
    first D/2 features against the last), not interleaved pairs."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    angles = positions[..., :, None].to(F32) * freq           # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      prefix_len: int = 0, chunk: int = 1024,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention: an online softmax over KV chunks.

    q: (B, S, H, D); k/v: (B, T, Hkv, D) with H % Hkv == 0.  The (S, T)
    score matrix is held one chunk at a time; the state is (m, l, acc)
    per query.  ``window`` masks to a local band; ``prefix_len`` makes the
    first P keys bidirectional (PaliGemma-style prefix-LM).  The last
    chunk is short rather than padded: padded keys are masked out in the
    reference, so the two agree.
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = D ** -0.5
    q = q.float() * scale
    dev = q.device
    q_pos = torch.arange(S, device=dev)[:, None]              # query positions
    m = torch.full((B, H, S), float("-inf"), dtype=F32, device=dev)
    l = torch.zeros((B, H, S), dtype=F32, device=dev)
    acc = torch.zeros((B, H, S, D), dtype=F32, device=dev)
    for start in range(0, T, chunk):
        kb = k[:, start: start + chunk].repeat_interleave(rep, dim=2)
        vb = v[:, start: start + chunk].repeat_interleave(rep, dim=2)
        kv_pos = start + torch.arange(kb.shape[1], device=dev)[None, :]
        s = torch.einsum("bshd,bthd->bhst", q, kb.float())
        s = _softcap(s, softcap)
        mask = torch.ones((S, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            c = q_pos >= kv_pos
            if prefix_len:
                c = c | (kv_pos < prefix_len)
            mask &= c
        if window is not None:
            mask &= (q_pos - kv_pos) < window
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Guard fully-masked rows (m_new == -inf).
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p,
                                                   vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.transpose(1, 2).to(torch.bfloat16)             # (B, S, H, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     softcap: Optional[float] = None,
                     window: Optional[int] = None,
                     seq_shard=None) -> torch.Tensor:
    """Single-token attention over a cache.

    q: (B, 1, H, D); caches: (B, T, Hkv, D); length: an int, or a () or
    (B,) tensor of valid lengths.  Scores in f32 in the kv-head layout
    (q grouped per kv head); the probabilities are rounded to bf16 before
    the PV product, which runs in f32, as in the reference.

    ``seq_shard``: (mesh, axes) over which the caches' T dim is split
    (the caches are this rank's block of positions).  The scores and the
    masked softmax stay split; the max, the softmax's sum and the partial
    outputs are reduced over ``axes``, as the reference's constraint of
    the scores over "model" makes decode sequence-parallel.
    """
    B, _, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    qf = q.float() * D ** -0.5
    qg = qf.reshape(B, 1, Hkv, rep, D)
    s = torch.einsum("bqhrd,bthd->bhrqt", qg, k_cache.float())
    s = _softcap(s, softcap)
    start = 0 if seq_shard is None else _seq_start(seq_shard, T)
    pos = torch.arange(start, start + T,
                       device=q.device)[None, None, None, None]
    if torch.is_tensor(length):
        length = length.reshape(-1, 1, 1, 1, 1)
    valid = pos < length
    if window is not None:
        valid &= pos >= (length - window)
    s = torch.where(valid, s, float("-inf"))
    m = _seq_reduce(s.amax(dim=-1, keepdim=True), seq_shard, "max")
    e = torch.exp(s - m)
    l = _seq_reduce(e.sum(dim=-1, keepdim=True), seq_shard, "sum")
    p = (e / l).to(torch.bfloat16)
    out = torch.einsum("bhrqt,bthd->bqhrd", p.float(), v_cache.float())
    out = _seq_reduce(out, seq_shard, "sum")
    return out.reshape(B, 1, H, D).to(torch.bfloat16)


def _seq_start(seq_shard, T_local: int) -> int:
    """The first position of this rank's block of a split cache."""
    return block_index(*seq_shard)[0] * T_local


def _seq_reduce(t: torch.Tensor, seq_shard, op: str) -> torch.Tensor:
    return t if seq_shard is None else all_reduce(t, *seq_shard, op)


def attention_block(params, x, cfg: ModelConfig, positions, *,
                    window=None, prefix_len=0, kv_cache=None, cache_len=None,
                    seq_shard=None, out_sum=None, head_shard=None):
    """Full attention block.  Returns (out, new_kv): new_kv is (k, v) for
    prefill, or for decode the cache tuple itself, written in place at
    ``cache_len`` (an int).  ``seq_shard``: see ``decode_attention``; the
    new positions are written by the rank whose block holds them.
    ``out_sum``: under tensor parallelism, the sum of the ranks' partial
    output products, taken before the output is cast to ``x``'s dtype.
    ``head_shard``: (mesh, axes) over which the projections' heads are
    split (tensor parallelism); in decode every head's q, k and v are
    gathered for the cache, which holds every head, and this rank's
    heads of the attention output meet its block of ``wo``."""
    B, S, _ = x.shape
    # the heads of the projections given: all of them, or this rank's
    # block under tensor parallelism
    Dh = cfg.head_dim
    H, Hkv = params["wq"].shape[-1] // Dh, params["wk"].shape[-1] // Dh
    q = linear(x, params["wq"]).reshape(B, S, H, Dh)
    k = linear(x, params["wk"]).reshape(B, S, Hkv, Dh)
    v = linear(x, params["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(1, 1, H, Dh)
        k = k + params["bk"].reshape(1, 1, Hkv, Dh)
        v = v + params["bv"].reshape(1, 1, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if kv_cache is not None:
        if head_shard is not None:
            q, k, v = (all_gather(t, 2, *head_shard) for t in (q, k, v))
        k_cache, v_cache = kv_cache
        T_local = k_cache.shape[1]
        start = 0 if seq_shard is None else _seq_start(seq_shard, T_local)
        T = T_local * (1 if seq_shard is None else
                       block_index(*seq_shard)[1])
        ring = window is not None and T <= window
        # Ring buffer for local attention: slot = pos % T; every resident
        # entry is in-window by construction, so no extra window mask.
        idx = cache_len % T if ring else cache_len
        # as in the reference, the start is clamped so the update fits
        idx = max(0, min(idx, T - S))
        lo, hi = max(idx, start), min(idx + S, start + T_local)
        if lo < hi:
            k_cache[:, lo - start: hi - start] = k[:, lo - idx: hi - idx]
            v_cache[:, lo - start: hi - start] = v[:, lo - idx: hi - idx]
        length = min(cache_len + S, T) if ring else cache_len + S
        out = decode_attention(q, k_cache, v_cache, length, softcap=None,
                               window=None if ring else window,
                               seq_shard=seq_shard)
        if head_shard is not None:
            out = local_block(out, 2, *head_shard)
        new_kv = kv_cache
    else:
        out = chunked_attention(q, k, v, causal=True, window=window,
                                prefix_len=prefix_len)
        new_kv = (k, v)
    out = linear(out.reshape(B, S, H * Dh), params["wo"])
    if out_sum is not None:
        out = out_sum(out)
    return out.to(x.dtype), new_kv


def ffn_block(params, x, activation: str):
    """SwiGLU or GeGLU; GeLU is the tanh approximation (``jax.nn.gelu``'s
    default)."""
    gate = linear(x, params["w_gate"])
    up = linear(x, params["w_up"])
    if activation == "geglu":
        act = F.gelu(gate.float(), approximate="tanh")
    else:  # swiglu
        act = F.silu(gate.float())
    return linear(act.to(x.dtype) * up, params["w_down"])
