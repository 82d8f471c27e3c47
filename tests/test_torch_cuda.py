"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU with ``nvcc``; skips without one.  Run on a GPU host:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import program as P
from repro_torch.core.sparse_matrix import csr_matvec
from repro_torch.core.spmv import SpmvPlan
from repro_torch.data import matrices as mats
from repro_torch.kernels import _lib

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
