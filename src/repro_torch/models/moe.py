"""Mixture-of-Experts layer — where the paper's technique lives in an LM.

Token->expert dispatch is an SpMV-shaped irregular gather: the routing
matrix is a sparse (tokens x experts) matrix, expert capacity is the
nnz-balanced work distribution, and the optional *Valiant shuffle* is the
paper's random-reordering insight applied to dispatch — a random
pre-permutation of tokens keeps correlated token runs from converging on
one expert at the same time.

Dispatch is sort-based (no (tokens x E x capacity) one-hot): tokens are
sorted by expert id, ranked within expert, and gathered into an
(E, capacity, d) buffer — O(tokens * top_k) memory.

Under a sharded step's placement the layer routes the global token set
(every batch shard's rows, gathered), so capacity, ranks and drops are
the one-device ones; the expert products are split as the reference
constrains them: experts over "model" where E divides it (expert
parallelism, deepseek), otherwise capacity over "data" (grok at a model
axis that E does not divide).  Each rank then keeps its own rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .config import MoEConfig
from .layers import promote
from .sharding import active

F32 = torch.float32


def _constrain(x, *axes):
    from .model import _maybe_constrain
    return _maybe_constrain(x, *axes)


def _ep_possible(num_experts: int) -> bool:
    place = active()
    return place is not None and "model" in place.mesh.shape and \
        num_experts % place.mesh.shape["model"] == 0


def _expert_axes(num_experts: int) -> tuple:
    """(E, cap, d)-shaped buffers: expert-parallel over "model" when E
    divides the axis; otherwise capacity over "data".  Never both, as in
    the reference."""
    if _ep_possible(num_experts):
        return ("model", None, None)
    return (None, "data", None)


def _expert_constraint(t):
    """This rank's experts or capacity slots of an (E, cap, d) buffer."""
    return _constrain(t, *_expert_axes(t.shape[0]))


def _expert_release(t, shape):
    """Every rank's experts or slots of an (E, cap, d) buffer, gathered."""
    from .model import _maybe_release
    return _maybe_release(t, shape, *_expert_axes(shape[0]))


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8 * ((cap + 7) // 8), 8)      # sublane aligned


def route(params, x2d: torch.Tensor, cfg: MoEConfig):
    """Router logits -> (weights, expert ids) per token, top-k.

    Ties go to the lower expert id, as ``lax.top_k`` breaks them (a stable
    descending sort).  Under a placement whose batch is split, ``x2d``
    holds every shard's tokens and the z-loss is this rank's share: its
    own tokens' terms of the global mean, so that each token's gradient
    is formed on the rank that owns it."""
    logits = x2d.float() @ params["router"].float()
    srt, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights, ids = srt[:, : cfg.top_k], order[:, : cfg.top_k]   # (T, K)
    weights = torch.softmax(weights, dim=-1)
    # z-loss keeps router logits bounded (GShard/ST-MoE practice).
    sq = torch.logsumexp(logits, dim=-1) ** 2
    place = active()
    if place is None or not place.batch_sharded:
        zloss = torch.mean(sq) * cfg.router_zloss
    else:
        zloss = place.own_rows(sq).sum() / sq.shape[0] * cfg.router_zloss
    return weights, ids, zloss


def shuffle_perm(tokens: int, device,
                 generator: Optional[torch.Generator] = None):
    """The Valiant shuffle's permutation of ``tokens`` tokens, drawn from
    ``generator`` (a generator seeded with 0 when none is given)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randperm(tokens, generator=generator, device=device)


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig, activation: str,
            *, generator: Optional[torch.Generator] = None,
            perm: Optional[torch.Tensor] = None,
            combine: str = "scatter_psum"):
    """x: (B, S, d) -> (B, S, d), aux-loss scalar.

    Expert tensors: params["w_gate"|"w_up"]: (E, d, f), params["w_down"]:
    (E, f, d).  ``perm`` is the Valiant shuffle's token permutation
    (``cfg.valiant_shuffle``); without one, ``shuffle_perm`` draws it
    from ``generator``.  ``combine``:
    ``"scatter_psum"`` scatter-adds the weighted bf16 expert rows into
    token order (``index_put_`` with accumulate: in slot order on the
    CPU, as the reference adds them; on CUDA PyTorch sorts the indices
    first, so the order differs from the CPU's but repeats from call to
    call), ``"gather"`` gathers each (token, k) row and sums in f32.
    """
    B, S, d = x.shape
    dev = x.device
    place = active()
    x2d = x.reshape(B * S, d)
    if place is not None:
        x2d = place.gather_rows(x2d)        # every batch shard's tokens
    T = x2d.shape[0]

    if cfg.valiant_shuffle:
        # Permute the token order entering dispatch so same-expert runs
        # decorrelate (the paper's random reordering).
        if perm is None:
            perm = shuffle_perm(T, dev, generator)
        x2d = x2d[perm]
    else:
        perm = None

    weights, ids, zloss = route(params, x2d, cfg)
    sp = cfg.expert_split
    if sp > 1:
        # exact decomposition: expert e == sum of thin experts (e*sp + j);
        # each half receives the token with the SAME routing weight.
        ids = (ids[..., None] * sp + torch.arange(sp, device=dev)
               ).reshape(ids.shape[0], -1)
        weights = weights.repeat_interleave(sp, dim=-1)
    E, K = cfg.num_experts * sp, cfg.top_k * sp
    # every thin expert receives the same tokens as its parent expert, so
    # capacity is NOT divided by sp.
    cap = _capacity(T, cfg)

    flat_ids = ids.reshape(-1)                                  # (T*K,)
    # Rank of each (token, k) within its expert = position in capacity buf.
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_pos = torch.arange(T * K, device=dev) - torch.searchsorted(
        sorted_ids, sorted_ids, side="left")
    ranked = torch.empty_like(flat_ids)
    ranked[order] = seg_pos
    # capacity drop; and a thin expert id past E is dropped too: with
    # expert_split > 1 the parameters' router has E = num_experts * sp
    # columns, so ids of num_experts and up expand past E, where the
    # reference's scatters drop them (its gather combine reads NaN there)
    keep = (ranked < cap) & (flat_ids < E)
    trash = E * cap                                            # one trash slot
    slot = torch.where(keep, flat_ids * cap + ranked, trash)

    # Dispatch: gather tokens into the (E, cap, d) buffer through the
    # inverse slot -> token map (empty slots read a zero row, index T).
    tok_of_slot = torch.full((trash + 1,), T, dtype=torch.long, device=dev)
    tok_of_slot[slot] = torch.arange(T * K, device=dev) // K
    tok_of_slot = tok_of_slot[:trash]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    expert_in = _expert_constraint(x_pad[tok_of_slot].reshape(E, cap, d))

    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if _ep_possible(E) and wg.shape[0] == E:
        # gathered whole (stored split inside each expert): this rank's
        # experts; stored with the experts split, they are gathered as
        # this rank's experts already
        wg, wu, wd = (_constrain(w, "model", None, None)
                      for w in (wg, wu, wd))
    h_gate = torch.bmm(*promote(expert_in, wg))
    h_up = torch.bmm(*promote(expert_in, wu))
    if activation == "geglu":
        act = F.gelu(h_gate.float(), approximate="tanh")
    else:
        act = F.silu(h_gate.float())
    h = act.to(x.dtype) * h_up
    expert_out = _expert_release(torch.bmm(*promote(h, wd)), (E, cap, d))

    flat_out = expert_out.reshape(E * cap, d)
    w_kept = weights * keep.reshape(T, K)
    if combine == "scatter_psum":
        w_of_slot = torch.zeros((trash + 1,), dtype=F32, device=dev)
        w_of_slot[slot] = w_kept.reshape(T * K)
        # bf16 contributions; each token sums <= top_k bf16 terms.
        contrib = (flat_out.float() * w_of_slot[:trash, None]).to(x.dtype)
        y = torch.zeros((T + 1, d), dtype=x.dtype, device=dev)
        y.index_put_((tok_of_slot,), contrib, accumulate=True)
        y = y[:T]
    else:
        flat_pad = torch.cat([flat_out, flat_out.new_zeros((1, d))], dim=0)
        gathered = flat_pad[slot].reshape(T, K, d)
        y = torch.einsum("tkd,tk->td", gathered.float(), w_kept).to(x.dtype)

    # Load-balance aux loss (Switch-style): mean prob * mean assignment.
    me = _one_hot(ids, E).mean(dim=(0, 1))
    balance = torch.sum(me * me) * E * 1e-2 / max(sp, 1)
    if place is not None and not place.batch_leader:
        # no gradient: one rank's share carries it
        balance = torch.zeros_like(balance)
    aux = balance + zloss

    if perm is not None:
        y = y[torch.argsort(perm)]
    if place is not None:
        y = place.own_rows(y)
    return y.reshape(B, S, d), aux


def shared_ffn(params, x: torch.Tensor, activation: str):
    """Always-on shared experts (DeepSeekMoE): standard FFN on every token."""
    from .layers import ffn_block
    return ffn_block(params, x, activation)


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot rows; an id outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(F32)


def expert_load(ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Tokens per expert (float32) — the collective-skew diagnostic."""
    return _one_hot(ids.reshape(-1), num_experts).sum(dim=0)
