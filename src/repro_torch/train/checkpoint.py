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

From a distributed mesh (``save(shardings=)``) rank 0 writes
``host_000.npz`` with every leaf whole, as the reference writes full
logical arrays, so the files restore in either package on any mesh.
Each leaf is gathered a block of its dim 0 at a time (about
``BLOCK_BYTES`` of the whole array; dim 0 whole where it is split), and
rank 0 streams each block into the file as it comes (synchronously), so
a device or the host holds one block beyond the shards.
``restore(shardings=)`` reads each rank's shard of each array a block at
a time in the same way (the elastic re-shard).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zipfile
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.models.sharding import block_index, entry_axes, \
    local_block

Tree = Any
_WRITER: Optional["_AsyncWriter"] = None
#: Bytes of a whole array that a sharded save or restore moves at a time.
BLOCK_BYTES = 1 << 28


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
         *, blocking: bool = False, shardings: Tree = None) -> str:
    """Write ``{"params", "opt"}`` at ``step``.  ``shardings`` (the same
    structure, ``NamedSharding`` leaves): the leaves are this rank's
    shards; every rank must call, and rank 0 writes the whole arrays
    (``_save_whole``)."""
    state = {"params": params, "opt": opt_state}
    names = leaf_names(state)
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    if shardings is not None:
        _save_whole(path, step, names, tree_leaves(state),
                    tree_leaves(shardings))
        return path
    arrays = [_savable(t) for t in tree_leaves(state)]
    manifest = {"step": step, "names": names,
                "shapes": [list(a.shape) for a in arrays],
                "dtypes": [str(a.dtype) for a in arrays]}
    os.makedirs(ckpt_dir, exist_ok=True)
    w = _writer()
    w.submit(path, names, arrays, manifest, _rank())
    if blocking:
        w.wait()
    return path


def _parts(entry, mesh) -> int:
    return block_index(mesh, entry_axes(entry))[1]


def _whole_shape(local: torch.Tensor, s) -> tuple:
    spec = tuple(s.spec) + (None,) * (local.dim() - len(s.spec))
    return tuple(n * _parts(e, s.mesh) for n, e in zip(local.shape, spec))


def _row_blocks(shape, s, itemsize: int) -> list:
    """Slices of dim 0 that hold about ``BLOCK_BYTES`` of the whole array
    each; all of dim 0 where it is split (or there is none)."""
    if not shape or (s.spec and entry_axes(s.spec[0])):
        return [slice(None)]
    row = itemsize
    for n in shape[1:]:
        row *= n
    rows = max(1, BLOCK_BYTES // max(row, 1))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


def _save_whole(path, step, names, leaves, shardings) -> None:
    """Every leaf whole into rank 0's ``host_000.npz``: every rank
    gathers each block (``_row_blocks``), and rank 0 streams it into the
    leaf's ``.npy`` entry, then writes the manifest and renames, as the
    writer thread does."""
    rank0 = _rank() == 0
    tmp = path + ".tmp"
    zf = None
    if rank0:
        os.makedirs(tmp, exist_ok=True)
        zf = zipfile.ZipFile(os.path.join(tmp, "host_000.npz"), "w",
                             allowZip64=True)
    shapes, dtypes = [], []
    for name, t, s in zip(names, leaves, shardings):
        shape = _whole_shape(t, s)
        dt = _savable(t.reshape(-1)[:0]).dtype
        shapes.append(list(shape))
        dtypes.append(str(dt))
        f = None
        if rank0:
            f = zf.open(name + ".npy", "w", force_zip64=True)
            np.lib.format.write_array_header_1_0(f, {
                "descr": np.lib.format.dtype_to_descr(dt),
                "fortran_order": False, "shape": shape})
        for rows in _row_blocks(shape, s, dt.itemsize):
            whole = s.gather(t[rows] if t.dim() else t)
            if rank0:
                f.write(_savable(whole).tobytes())
            del whole
        if rank0:
            f.close()
    if not rank0:
        return
    zf.close()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "names": names, "shapes": shapes,
                   "dtypes": dtypes}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def wait_for_writes():
    """Drain this process's writer; with a process group up, every rank
    must call, and all return once every rank's writes are on disk."""
    if _WRITER is not None:
        _WRITER.wait()
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Tree, shardings: Tree = None,
            *, device="cuda") -> tuple[Tree, int]:
    """Restore into the structure of ``like`` ({"params": ..., "opt": ...},
    tensors or ``meta`` tensors), each leaf cast to its ``like`` leaf's
    dtype and placed on ``device``; with ``shardings`` (the same
    structure, ``NamedSharding`` leaves of the target mesh), each leaf is
    this rank's shard of the whole array, on the mesh's device, read
    from the whole arrays' file (``host_000.npz``)."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = leaf_names(like)
    if names != manifest["names"]:
        raise ValueError(f"checkpoint/model structure mismatch under {path}")
    if shardings is not None:
        with zipfile.ZipFile(os.path.join(path, "host_000.npz")) as zf:
            out = [_read_shard(zf, name, s, ref.dtype) for name, ref, s in
                   zip(names, tree_leaves(like), tree_leaves(shardings))]
        return tree_unflatten(like, out), manifest["step"]
    out = []
    with np.load(os.path.join(path, f"host_{_rank():03d}.npz")) as data:
        for name, ref in zip(names, tree_leaves(like)):
            t = torch.from_numpy(np.array(data[name])).to(dtype=ref.dtype)
            out.append(t.to(dev))
    return tree_unflatten(like, out), manifest["step"]


_READ_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _read_shard(zf: zipfile.ZipFile, name: str, s, dtype) -> torch.Tensor:
    """This rank's shard (placement ``s``) of the whole array ``name``,
    as ``dtype`` on the mesh's device: read from its ``.npy`` entry a
    block of dim 0 at a time (``_row_blocks``), only this rank's rows
    where dim 0 is split."""
    with zf.open(name + ".npy") as f:
        shape, fortran, dt = _READ_HEADER[np.lib.format.read_magic(f)](f)
        if fortran:
            raise ValueError(f"{name}: Fortran-ordered arrays are not read")
        if not shape:
            return s.local(torch.from_numpy(np.frombuffer(
                f.read(dt.itemsize), dt).reshape(()).copy()).to(dtype))
        spec = tuple(s.spec) + (None,) * (len(shape) - len(s.spec))
        row = dt.itemsize
        for n in shape[1:]:
            row *= n
        lo, hi = 0, shape[0]
        if entry_axes(spec[0]):
            i, n = block_index(s.mesh, entry_axes(spec[0]))
            lo, hi = i * shape[0] // n, (i + 1) * shape[0] // n
            f.seek(lo * row, 1)
        out = None
        for rows in _row_blocks(shape, s, dt.itemsize):
            r0, r1 = rows.indices(hi - lo)[:2]
            block = np.frombuffer(f.read((r1 - r0) * row), dt).reshape(
                (r1 - r0, *shape[1:]))
            x = torch.from_numpy(block.copy())
            for d, e in enumerate(spec[1:], 1):
                if entry_axes(e):
                    x = local_block(x, d, s.mesh, entry_axes(e))
            if out is None:
                out = torch.empty((hi - lo, *x.shape[1:]), dtype=dtype,
                                  device=s.mesh.local_device)
            out[r0:r1] = x.to(dtype)
        return out
