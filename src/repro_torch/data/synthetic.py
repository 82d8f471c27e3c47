"""Synthetic token pipeline: deterministic, shardable, restart-exact.

A copy of ``repro.data.synthetic``.  A real deployment swaps
``TokenStream`` for a file-backed loader; everything downstream (restart
bookkeeping) is identical.  Each batch is drawn with numpy from
``np.random.default_rng`` keyed by (seed, step), so a restarted job
regenerates byte-identical batches (no data-loader state in checkpoints
beyond the step counter), and the port's stream is bitwise the
reference's.  The arrays stay numpy; the training loop moves them to the
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128


class TokenStream:
    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given step — pure function of (seed, step)."""
        cfg, d = self.cfg, self.data
        rng = np.random.default_rng(np.uint64(d.seed * 1_000_003 + step))
        B, S = d.batch, d.seq_len
        if cfg.frontend == "encodec_stub":
            return {
                "frames": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S, cfg.num_codebooks)).astype(np.int32),
            }
        if cfg.frontend == "siglip_stub":
            P = cfg.prefix_len
            return {
                "image_embeds": rng.standard_normal((B, P, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S - P)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S - P)).astype(np.int32),
            }
        # LM: structured-ish stream (Zipf tokens + shifted labels) so loss
        # actually decreases during the e2e example runs.
        toks = (rng.zipf(1.3, (B, S + 1)) % cfg.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
