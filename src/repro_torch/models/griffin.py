"""Griffin/RecurrentGemma blocks: RG-LRU recurrent block (arXiv:2402.19427).

The RG-LRU is a diagonal gated linear recurrence — h_t = a_t * h_{t-1} +
sqrt(1 - a_t^2) * (i_t * u_t) — which runs over a sequence as a log-depth
scan and decodes with an O(1) step.  The block is the Griffin recurrent
block: a GeLU linear branch gating a (causal conv -> RG-LRU) branch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import linear

F32 = torch.float32
_C = 8.0  # Griffin's fixed recurrence sharpness


def _gates(u, r_gate, i_gate, lam):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, in f32."""
    log_a = -_C * F.softplus(lam.float()) * torch.sigmoid(r_gate.float())
    a = torch.exp(log_a)
    gated = torch.sigmoid(i_gate.float()) * u.float()
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    return a, b


def _rg_lru_scan(u, r_gate, i_gate, lam, h0=None):
    """u/r_gate/i_gate: (B, S, D); lam: (D,) logits of a.  Returns the
    (B, S, D) bf16 outputs and the last f32 state.

    A log-depth (Hillis-Steele) scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2).  The reference's
    ``associative_scan`` combines in another order, so the two agree to
    f32 rounding, not bitwise."""
    a, b = _gates(u, r_gate, i_gate, lam)
    if h0 is not None:
        # Fold the carried state into the first step's offset.
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift]
                       + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b.to(torch.bfloat16), b[:, -1]


def _rg_lru_step(u, r_gate, i_gate, lam, h_prev):
    a, b = _gates(u, r_gate, i_gate, lam)
    h = a * h_prev.float() + b
    return h.to(torch.bfloat16), h


def causal_conv1d(x, kernel, conv_state=None):
    """Depthwise causal conv.  x: (B, S, D); kernel: (W, D).

    conv_state: (B, W-1, D) trailing inputs from the previous call (decode).
    Returns (y, new_state).
    """
    W = kernel.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+W-1, D)
    y = sum(xp[:, i: i + x.shape[1]] * kernel[i][None, None]
            for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return y, new_state


def rglru_block(params, x, cfg, state=None, *, decode=False):
    """Griffin recurrent block.  state: (h, conv_state)."""
    gate = F.gelu(linear(x, params["w_gelu_gate"]).float(),
                  approximate="tanh").to(x.dtype)
    u = linear(x, params["w_in"])
    h_prev, conv_state = (None, None) if state is None else state
    u, conv_state = causal_conv1d(u, params["conv_kernel"], conv_state)
    r_gate = linear(u, params["w_rgate"])
    i_gate = linear(u, params["w_igate"])
    if decode:
        h, h_last = _rg_lru_step(u[:, 0], r_gate[:, 0], i_gate[:, 0],
                                 params["lam"], h_prev)
        h = h[:, None]
    else:
        h, h_last = _rg_lru_scan(u, r_gate, i_gate, params["lam"], h_prev)
    out = linear(h * gate, params["w_out"])
    return out, (h_last, conv_state)
