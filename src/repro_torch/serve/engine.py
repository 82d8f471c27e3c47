"""Batched LM serving engine: prefill + decode on one device.

The port of ``repro.serve.engine.Engine``.  Caches are allocated once per
``generate`` and updated in place by each step; the prompt is prefilled
by stepping its tokens through the decode path, as in the reference.

The sparse-matrix router's names (:class:`SparseMatrixEngine`,
:class:`IngestedMatrix`, :class:`MicroBatchConfig`) are re-exported from
:mod:`repro_torch.serve.router`, as the reference's ``serve.engine``
re-exports them, so ``from repro_torch.serve.engine import
SparseMatrixEngine`` works as it does there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as mm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_map
from repro_torch.serve.router import IngestedMatrix, MicroBatchConfig, \
    SparseMatrixEngine

__all__ = ["Engine", "ServeConfig", "SparseMatrixEngine",
           "IngestedMatrix", "MicroBatchConfig"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 256
    temperature: float = 0.0      # 0 = greedy


class Engine:
    """Single-device batched generation (KV/recurrent caches threaded).

    Runs on ``device`` (CUDA unless the caller passes ``device="cpu"``;
    raises where CUDA is asked for and absent); ``params`` are moved there.
    """

    def __init__(self, cfg: ModelConfig, params,
                 serve_cfg: ServeConfig = ServeConfig(), *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.serve_cfg = serve_cfg

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, steps: int,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """prompts: (B, S0) int -> (B, S0 + steps) int32 tokens.

        Edge semantics, as in the reference:

        * ``steps == 0`` returns the prompts unchanged (no decode work);
        * ``S0 == 0`` with ``steps > 0`` raises ``ValueError`` — decoding
          needs at least one prefilled token to produce logits, so callers
          seed the prompt (e.g. with BOS) explicitly;
        * sampling (``temperature > 0``) requires an explicit
          ``torch.Generator`` on the engine's device (the reference's
          ``key=``); it never falls back to greedy decoding.

        Greedy decoding takes the first maximum on ties, as ``jnp.argmax``
        does; multi-codebook models decode codebook 0's head.
        """
        B, S0 = prompts.shape
        if steps == 0:
            return np.asarray(prompts, np.int32).copy()
        temperature = self.serve_cfg.temperature
        if temperature > 0 and self.cfg.num_codebooks <= 1 \
                and generator is None:
            raise ValueError(
                f"temperature={temperature} requires a generator: pass "
                f"generator=torch.Generator(device).manual_seed(seed) to "
                f"generate(), or set temperature=0 for greedy decoding")
        if S0 == 0:
            raise ValueError(
                "cannot decode from an empty prompt (S0 == 0): there are "
                "no logits to sample the first token from; seed each "
                "prompt with at least one token (e.g. BOS)")
        caches = mm.init_cache(self.cfg, B, self.serve_cfg.max_len,
                               device=self.device)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        for t in range(S0):
            logits, caches = mm.decode_step(self.params, self.cfg,
                                            toks[:, t: t + 1], caches, t)
        out = [toks]
        for i in range(steps):
            if self.cfg.num_codebooks > 1:
                nxt = torch.argmax(logits[:, 0], dim=-1)[:, :1]   # head 0
            elif temperature > 0:
                probs = torch.softmax(logits[:, 0] / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = torch.argmax(logits[:, 0], dim=-1)[:, None]
            out.append(nxt)
            if i + 1 < steps:   # the last token's logits are never read
                logits, caches = mm.decode_step(self.params, self.cfg, nxt,
                                                caches, S0 + i)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
