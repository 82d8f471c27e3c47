"""Async, atomic checkpoints (npz + JSON manifest), readable by both
packages.

Layout, as ``repro.train.checkpoint`` writes it::

    <dir>/step_000123/          # atomic: written as .tmp then renamed
        manifest.json           # step, leaf names, shapes, dtypes
        host_000.npz            # this rank's leaves (full arrays)

Leaf names are the key paths ``jax.tree_util`` prints (``['params']/
['embed']``, ``['opt']/.m/['embed']``, ``['opt']/.step``), so a checkpoint
written by either package restores in the other.  bf16 leaves are widened
to float32 on disk (npz has no bf16); ``restore`` casts each leaf back to
the dtype of the tree it restores into.  The device-to-host copy is
synchronous; serialisation and the rename happen on a background writer
thread, which ``wait_for_writes`` drains.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.params import tree_leaves, tree_unflatten

Tree = Any
_WRITER: Optional["_AsyncWriter"] = None


def leaf_names(tree: Tree, prefix: str = "") -> List[str]:
    """Each leaf's key path as ``jax.tree_util`` prints it, in
    ``tree_leaves``'s order: ``['key']`` for a dict key, ``.field`` for a
    NamedTuple field, ``[i]`` for a sequence index, joined by ``/``."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], join(f"[{k!r}]"))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f in tree._fields
                for n in leaf_names(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (tuple, list)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, join(f"[{i}]"))]
    return [prefix]


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class _AsyncWriter:
    def __init__(self):
        self.q: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            path, names, arrays, manifest, rank = item
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"host_{rank:03d}.npz"),
                     **dict(zip(names, arrays)))
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self.q.task_done()

    def submit(self, *item):
        self.q.put(item)

    def wait(self):
        self.q.join()


def _writer() -> _AsyncWriter:
    global _WRITER
    if _WRITER is None:
        _WRITER = _AsyncWriter()
    return _WRITER


def _savable(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` taken now (bf16 widened to float32 on the
    host): a donated step updates the live buffers in place while the
    writer serialises."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.cpu().float().numpy()          # .float() copies
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, params: Tree, opt_state: Tree, step: int,
         *, blocking: bool = False) -> str:
    state = {"params": params, "opt": opt_state}
    names = leaf_names(state)
    arrays = [_savable(t) for t in tree_leaves(state)]
    manifest = {"step": step, "names": names,
                "shapes": [list(a.shape) for a in arrays],
                "dtypes": [str(a.dtype) for a in arrays]}
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    w = _writer()
    w.submit(path, names, arrays, manifest, _rank())
    if blocking:
        w.wait()
    return path


def wait_for_writes():
    if _WRITER is not None:
        _WRITER.wait()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Tree, *,
            device="cuda") -> tuple[Tree, int]:
    """Restore into the structure of ``like`` ({"params": ..., "opt": ...},
    tensors or ``meta`` tensors), each leaf cast to its ``like`` leaf's
    dtype and placed on ``device``."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = leaf_names(like)
    if names != manifest["names"]:
        raise ValueError(f"checkpoint/model structure mismatch under {path}")
    with np.load(os.path.join(path, f"host_{_rank():03d}.npz")) as data:
        out = [torch.from_numpy(np.array(data[name])).to(device=dev,
                                                          dtype=ref.dtype)
               for name, ref in zip(names, tree_leaves(like))]
    return tree_unflatten(like, out), manifest["step"]
