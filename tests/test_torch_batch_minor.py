"""The executor's batch-minor x buffers on the CPU.

Every kernel reads x as (Sx, Lx, B): element (col, b) of a shard at
``col * B + b``.  The local buffer is the caller's (S, per, B) block as it
is, and the exchange gathers whole rows into (Sx, Lx, B).  Here, for each
kernel family and a program mixing two, at B = 1, 3, 8 and 16: the
buffers ``run.buffers`` gives are those of the batch-major convention the
kernels read before (built below from the same exchange index) with the
batch moved last, and column b of the executor's y is the B = 1 call on
column b, bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats

# Tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

PROGRAMS = {
    "seg": dict(num_shards=4, kernel="seg"),
    "split": dict(num_shards=4, kernel="split"),
    "hyb": dict(num_shards=4, kernel="hyb", exchange="halo"),
    "ell-cyclic": dict(num_shards=4, kernel="ell", layout="cyclic",
                       exchange="allgather"),
    "tile": dict(num_shards=4, kernel="tile"),
    "split+seg": dict(num_shards=4, shard_kernels=("split", "split", "seg",
                                                   "seg")),
}


def _matrix(name):
    if name == "tile":
        return mats.blocked_band(2048, 2048 * 24, seed=0)
    return mats.powerlaw_tail(2048, 2048 * 16, n_monster=4, seed=0)


def _batch_major_buffers(prog, xs):
    """The (S, B, per) local and (Sx, B, Lx) remote buffers as the
    batch-major convention built them: a permuted copy of x, and the
    exchange index gathered from the (B, S * per) flat x."""
    S, per, B = xs.shape
    local = xs.permute(0, 2, 1).contiguous()
    index = torch.from_numpy(P._exchange_index(prog, P._device_operands(prog)))
    flat = local.permute(1, 0, 2).reshape(B, S * per)
    return local, flat[:, index].permute(1, 0, 2).contiguous()


@pytest.mark.parametrize("B", [1, 3, 8, 16])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_buffers_are_batch_minor_and_columns_bitwise(name, B):
    A = _matrix(name)
    prog = P.lower(A, SpmvPlan(**PROGRAMS[name]))
    run = P.make_program_spmv_fn(prog, device="cpu")
    x = np.random.default_rng(B).standard_normal((A.ncols, B)) \
        .astype(np.float32)
    xs = torch.from_numpy(prog.x_to_device(x))
    S, per = xs.shape[:2]
    xb, xg = run.buffers(xs)
    assert xb.shape == (S, per, B) and xb.data_ptr() == xs.data_ptr()
    Sx, Lx = xg.shape[:2]
    assert xg.shape == (Sx, Lx, B) and xg.is_contiguous()
    old_local, old_remote = _batch_major_buffers(prog, xs)
    assert torch.equal(xb, old_local.transpose(1, 2))
    assert torch.equal(xg, old_remote.transpose(1, 2))
    y = run(xs)
    assert y.shape[-1] == B
    for b in range(B):
        assert torch.equal(y[..., b], run(xs[..., b].contiguous()))
    np.testing.assert_allclose(P.gather_b(prog, y),
                               P.execute(prog, x, backend="numpy"),
                               rtol=2e-4, atol=2e-4)
