"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Run on a GPU host:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core.sparse_matrix import csr_from_coo, csr_matvec
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats
from repro_torch.kernels import _lib, ops, spmv_split, spmv_tile

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


PLANS = {
    "mixed": dict(num_shards=8, shard_kernels=(
        "tile", "tile", "tile", "ell", "hyb", "seg", "split", "seg"),
        split_counts=(1, 1, 1, 1, 1, 1, 4, 1),
        shard_exchanges=("halo", "allgather") * 4),
    "split": dict(num_shards=4, kernel="split"),
    "ell-cyclic": dict(num_shards=4, kernel="ell", layout="cyclic",
                       exchange="allgather"),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_card_matches_plain_path(device, name):
    A = mats.blocked_band(4096, 4096 * 24, seed=0) if name == "mixed" \
        else mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    prog = P.lower(A, SpmvPlan(**PLANS[name]))
    x = np.random.default_rng(0).standard_normal((A.ncols, 4))
    _lib.reset_launch_counts()
    got = P.execute(prog, x, backend="device", device=device)
    assert sum(_lib.launch_counts.values()) > 0
    plain = P.execute(prog, x, backend="device", device="cpu")
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, csr_matvec(A, x), rtol=2e-4, atol=2e-4)
    xs = torch.from_numpy(prog.x_to_device(x.astype(np.float32))).to(device)
    y = P.make_program_spmv_fn(prog, device=device)(xs)
    y_serial = P.make_program_spmv_fn(prog, device=device,
                                      pipeline=False)(xs)
    assert torch.equal(y, y_serial)
    y0 = P.make_program_spmv_fn(prog, device=device)(xs[..., 0])
    assert torch.equal(y[..., 0], y0)


def _card_and_plain(kernel, plain, args, abs_args):
    """One launch of ``kernel`` on the card, counted, against its plain
    version on the same inputs (rtol = atol = 1e-5 on |A|.|x|)."""
    _lib.reset_launch_counts()
    got = kernel(*args)
    torch.cuda.synchronize()
    assert sum(_lib.launch_counts.values()) == 1
    want = plain(*args, torch.empty_like(got))
    scale = plain(*abs_args, torch.empty_like(got))
    assert bool(((got - want).abs() <= 1e-5 * (1.0 + scale)).all())


def _x(n, B):
    return np.random.default_rng(1).standard_normal((n, B)).astype(np.float32)


@pytest.mark.parametrize("ns", [8, 64])
def test_split_psum_and_split_spmv_on_card(device, ns):
    A = mats.powerlaw_tail(4096, 4096 * 16, n_monster=4, seed=0)
    spl = ops.split_from_csr(A, ns)
    vals, cols = (torch.from_numpy(a).to(device) for a in (spl.vals,
                                                          spl.cols))
    x = _x(A.ncols, 3)
    xb = torch.from_numpy(x.T.copy()).to(device)
    _card_and_plain(spmv_split.split_psum, spmv_split.split_psum_plain,
                    (vals, cols, xb), (vals.abs(), cols, xb.abs()))
    y = ops.split_spmv(spl, x, device=device)
    np.testing.assert_allclose(y.cpu(), csr_matvec(A, x), rtol=2e-4,
                               atol=2e-4)
    for b in range(3):
        assert torch.equal(y[:, b], ops.split_spmv(spl, x[:, b].copy(),
                                                   device=device))


@pytest.mark.parametrize("bm", [8, 16, 128])
def test_tile_walk_and_tile_spmv_on_card(device, bm):
    # 4000 columns, so the last x block is cut (4000 % 128 != 0); rows
    # 800-1599 emptied, so whole block rows have no tiles
    P = mats.powerlaw_tail(4000, 4000 * 8, n_monster=2, seed=0)
    rows = np.repeat(np.arange(4000), np.diff(P.row_ptr))
    keep = (rows < 800) | (rows >= 1600)
    A = csr_from_coo(rows[keep], P.col_index[keep], P.values[keep],
                     P.shape)
    t = ops.tile_from_csr(A, bm=bm)
    assert (np.diff(t.tile_ptr) == 0).any()
    data, tcols, tptr = (torch.from_numpy(a).to(device) for a in (
        t.data, t.tile_cols, t.tile_ptr))
    x = _x(A.ncols, 3)
    xb = torch.from_numpy(x.T.copy()).to(device)
    _card_and_plain(spmv_tile.tile_walk_spmv, spmv_tile.tile_walk_spmv_plain,
                    (data, tcols, tptr, xb), (data.abs(), tcols, tptr,
                                              xb.abs()))
    y = ops.tile_spmv(t, x, device=device)
    np.testing.assert_allclose(y.cpu(), csr_matvec(A, x), rtol=2e-4,
                               atol=2e-4)
    for b in range(3):
        assert torch.equal(y[:, b], ops.tile_spmv(t, x[:, b].copy(),
                                                  device=device))
