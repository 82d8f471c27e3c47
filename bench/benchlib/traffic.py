"""The traffic generator: reads a mix's parameters from
``bench/traffic/<mix>.json`` and draws everything from the run's seed.

A mix names its ``kind``, the module ``bench/kinds/<kind>.py`` that
drives the system under it (set-up, the measured window, the answers it
hands to the check), and holds that kind's parameters, which the
module lists as ``KEYS``.  A new mix of a kind that exists is a data
file alone; a new kind is a new module beside the others.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import named

__all__ = ["load", "kind", "vectors", "sample"]


def kind(name: str):
    """The module ``bench/kinds/<name>.py``."""
    return named.module("kinds", name)


def load(name: str, root: Path) -> dict:
    """The mix ``name``'s parameters, checked against its kind's keys."""
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    keys = set(kind(mix["kind"]).KEYS)
    extra = set(mix) - keys - {"kind", "why"}
    missing = keys - set(mix)
    if extra or missing:
        raise ValueError(f"traffic {name}: unknown keys {sorted(extra)}, "
                         f"missing keys {sorted(missing)}")
    return mix


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def vectors(n: int, count: int, block: int, *, seed: int, device,
            dtype=torch.float32) -> list:
    """``count`` x of (n,) (``block`` 1) or (n, block), standard normal,
    drawn on ``device`` in one call."""
    g = _generator(seed, 1, device)
    X = torch.randn((count, n, block), generator=g, device=device,
                    dtype=torch.float64).to(dtype)
    return [X[i, :, 0] if block == 1 else X[i] for i in range(count)]


def sample(n: int, k: int, *, seed: int, stream: int) -> np.ndarray:
    """``k`` distinct indices of ``n`` (all when k >= n), drawn from the
    seed, sorted."""
    rng = np.random.default_rng([seed % (1 << 63), stream])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
