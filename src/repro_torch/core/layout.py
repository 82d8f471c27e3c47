"""Dense-vector data layouts (paper §III-B).

* ``block``  — contiguous chunks of ceil(len/P) elements per shard; one
               "migration" per B consecutive remote accesses.
* ``cyclic`` — element round-robin (Emu's ``mw_malloc1dlong``); every
               consecutive remote access changes owner.

A host copy of ``repro.core.layout``: the same arithmetic, so the port's
exchange tables and operand remaps equal the reference's bitwise.  A
cyclic layout views the vector as (P, len/P) with element i on shard
i % P.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["VectorLayout", "block_layout", "cyclic_layout", "make_layout"]


@dataclasses.dataclass(frozen=True)
class VectorLayout:
    kind: str           # "block" | "cyclic"
    length: int
    num_shards: int
    block: int          # block layout: chunk size; cyclic: 1

    def owner_of(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        if self.kind == "block":
            return np.minimum(idx // self.block, self.num_shards - 1)
        return idx % self.num_shards

    def local_index(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        if self.kind == "block":
            return idx - self.owner_of(idx) * self.block
        return idx // self.num_shards

    def padded_length(self) -> int:
        if self.kind == "block":
            return self.block * self.num_shards
        per = -(-self.length // self.num_shards)
        return per * self.num_shards

    def to_sharded(self, v: np.ndarray) -> np.ndarray:
        """Host-side reshape to (P, per_shard[, B]) in layout order (pad 0).

        ``v`` is (length,) or a multi-RHS block (length, B); any trailing
        axes ride along untouched."""
        per = self.padded_length() // self.num_shards
        buf = np.zeros((self.padded_length(),) + v.shape[1:], dtype=v.dtype)
        buf[: self.length] = v
        if self.kind == "block":
            return buf.reshape((self.num_shards, per) + v.shape[1:])
        cyc = buf.reshape((per, self.num_shards) + v.shape[1:])
        return np.ascontiguousarray(np.swapaxes(cyc, 0, 1))

    def from_sharded(self, shards: np.ndarray) -> np.ndarray:
        if self.kind == "block":
            return shards.reshape((-1,) + shards.shape[2:])[: self.length]
        cyc = np.swapaxes(shards, 0, 1)
        return cyc.reshape((-1,) + shards.shape[2:])[: self.length]


def block_layout(length: int, num_shards: int) -> VectorLayout:
    block = -(-length // num_shards)
    return VectorLayout("block", length, num_shards, block)


def cyclic_layout(length: int, num_shards: int) -> VectorLayout:
    return VectorLayout("cyclic", length, num_shards, 1)


def make_layout(kind: str, length: int, num_shards: int) -> VectorLayout:
    if kind == "block":
        return block_layout(length, num_shards)
    if kind == "cyclic":
        return cyclic_layout(length, num_shards)
    raise ValueError(f"unknown vector layout: {kind!r}")
