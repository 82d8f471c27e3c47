"""xLSTM blocks (mLSTM + sLSTM) — the [ssm] architecture (arXiv:2405.04517).

mLSTM: matrix-memory LSTM ≈ gated linear attention.  Run over a sequence
in a chunkwise-parallel form (intra-chunk quadratic, inter-chunk recurrent
state (B, H, Dk, Dv)); decoded with the O(1) recurrent step.  Gates are
sigmoid, as in the reference (the numerically plain variant of the
paper's exp input gate).

sLSTM: scalar-memory LSTM with exp input gating + stabilizer state, a true
recurrence over time, block-diagonal recurrent matrices per head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import linear, promote

F32 = torch.float32


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_chunked(q, k, v, i_gate, f_gate, state=None, *, chunk: int = 256):
    """Chunkwise-parallel mLSTM.

    q/k: (B, S, H, Dk); v: (B, S, H, Dv); gates: (B, S, H) in (0, 1).
    state: optional (C, n) with C: (B, H, Dk, Dv), n: (B, H, Dk).
    Returns h: (B, S, H, Dv), new state.  Raises when the chunk does not
    divide S.
    """
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    W = min(chunk, S)
    if S % W:
        raise ValueError(f"seq {S} not divisible by chunk {W}")
    dev = q.device
    if state is None:
        C = torch.zeros((B, H, Dk, Dv), dtype=F32, device=dev)
        n = torch.zeros((B, H, Dk), dtype=F32, device=dev)
    else:
        C, n = state[0].float(), state[1].float()
    causal = torch.tril(torch.ones((W, W), dtype=torch.bool, device=dev))
    hs = []
    for start in range(0, S, W):
        sl = slice(start, start + W)
        qw, kw, vw = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        iw, fw = i_gate[:, sl].float(), f_gate[:, sl].float()
        # log-cumulative decay within the chunk: g[t] = prod_{s<=t} f[s]
        logf = torch.log(fw + 1e-12)                     # (B, W, H)
        csum = torch.cumsum(logf, dim=1)
        g = torch.exp(csum)                              # (B, W, H)
        g_total = torch.exp(csum[:, -1])                 # (B, H)
        # inter-chunk contribution: q_t (g_t) @ C_prev
        inter = torch.einsum("bwhk,bhkv->bwhv", qw * g[..., None], C)
        # intra-chunk: scores (t, s) masked causal with decay g_t / g_s
        ratio = torch.exp(csum[:, :, None, :] - csum[:, None, :, :])
        wts = torch.where(causal[None, :, :, None], ratio, 0.0)
        scores = torch.einsum("bthk,bshk->btsh", qw, kw) * wts * \
            iw[:, None, :, :]
        intra = torch.einsum("btsh,bshv->bthv", scores, vw)
        # normalizer: same recurrences with k instead of k v^T
        n_inter = torch.einsum("bwhk,bhk->bwh", qw * g[..., None], n)
        n_intra = scores.sum(dim=2)                      # (B, W, H)
        denom = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)
        hs.append((inter + intra) / denom[..., None])
        # state update
        decay_s = torch.exp(csum[:, -1, None, :] - csum)  # (B, W, H)
        kd = kw * (iw * decay_s)[..., None]
        C = C * g_total[..., None, None] + torch.einsum(
            "bwhk,bwhv->bhkv", kd, vw)
        n = n * g_total[..., None] + kd.sum(dim=1)
    h = torch.cat(hs, dim=1)
    return h.to(torch.bfloat16), (C, n)


def mlstm_step(q, k, v, i_gate, f_gate, state):
    """O(1) decode step.  q/k: (B, 1, H, Dk); v: (B, 1, H, Dv)."""
    C, n = state
    qs, ks, vs = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i = i_gate[:, 0].float()[..., None]
    f = f_gate[:, 0].float()[..., None]
    C = C * f[..., None] + i[..., None] * ks[..., :, None] * vs[..., None, :]
    n = n * f + i * ks
    num = torch.einsum("bhk,bhkv->bhv", qs, C)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", qs, n)), min=1.0)
    h = (num / den[..., None])[:, None]
    return h.to(torch.bfloat16), (C, n)


def mlstm_block(params, x, cfg, state=None, *, decode=False):
    """Full mLSTM residual block: up-proj -> mLSTM -> gate -> down-proj."""
    B, S, d = x.shape
    inner = params["w_qkv"].shape[1] // 4          # q, k, v, ogate widths
    H = cfg.num_heads
    proj = linear(x, params["w_qkv"])
    qkv, og = proj[..., : 3 * inner], proj[..., 3 * inner:]
    Dk = inner // H
    q, k, v = qkv.reshape(B, S, 3, H, Dk).unbind(dim=2)
    gates = linear(x, params["w_gates"])            # (B, S, 2H)
    i_gate = torch.sigmoid(gates[..., :H].float())
    f_gate = torch.sigmoid(gates[..., H:].float() + 4.0)   # open at init
    if decode:
        h, new_state = mlstm_step(q, k, v, i_gate, f_gate, state)
    else:
        # chunk grows with S so the chunk count stays bounded; intra-chunk
        # work is quadratic in chunk but caps at 1024.
        h, new_state = mlstm_chunked(q, k, v, i_gate, f_gate, state,
                                     chunk=min(max(256, S // 32), 1024))
    h = h.reshape(B, S, inner) * F.silu(og.float()).to(h.dtype)
    return linear(h, params["w_out"]), new_state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_block(params, x, cfg, state=None, *, decode=False):
    """sLSTM with exp input gate + stabilizer, block-diag recurrence.

    state: (h, c, n, m) each (B, H, Dh); a fresh state starts the
    stabilizer m at -10.  ``decode`` runs the same recurrence (S = 1).
    """
    B, S, d = x.shape
    H = cfg.num_heads
    inner = params["w_in"].shape[1] // 4
    Dh = inner // H
    xg = linear(x, params["w_in"]).reshape(B, S, 4, H, Dh)
    R = params["r_kernel"]                          # (H, Dh, 4*Dh)

    if state is None:
        z = torch.zeros((B, H, Dh), dtype=F32, device=x.device)
        state = (z, z, z, z - 10.0)
    h, c, n, m = state
    hs = []
    for t in range(S):
        xt = xg[:, t]
        rec = torch.einsum("bhd,hdg->bhg", *promote(h, R)).reshape(
            B, H, 4, Dh)
        rec = rec.movedim(2, 0)
        zt = torch.tanh(xt[:, 0].float() + rec[0])
        it_log = xt[:, 1].float() + rec[1]               # log input gate
        ft_log = F.logsigmoid(xt[:, 2].float() + rec[2] + 4.0)
        ot = torch.sigmoid(xt[:, 3].float() + rec[3])
        m_new = torch.maximum(ft_log + m, it_log)
        i_s = torch.exp(it_log - m_new)
        f_s = torch.exp(ft_log + m - m_new)
        c = f_s * c + i_s * zt
        n = torch.clamp(f_s * n + i_s, min=1e-6)
        h = ot * (c / n)
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, inner).to(torch.bfloat16)
    out = linear(out, params["w_out"])
    return out, (h, c, n, m)
