"""The kernel launchers run on the device of the tensors they are given.

The C launchers launch on whatever CUDA device is current, so
``_lib.call`` makes the tensors' device current and takes that device's
stream.  Here, without a card, ``_lib.lib``, ``torch.cuda.device`` and
``torch.cuda.current_stream`` are recording fakes: ``call`` itself on
``cuda:1`` while ``cuda:0`` is current, then each kernel wrapper on
``meta`` tensors (which have a device and shapes but no data), which
must hand ``call`` their own device.
"""
import contextlib

import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels import spmv_ell, spmv_seg, spmv_split, spmv_tile


class FakeCuda:
    """A current device, per-device streams and a library recording the
    device current at each launch."""

    def __init__(self, current):
        self.current = current
        self.launches = []

    @contextlib.contextmanager
    def device(self, dev):
        saved, self.current = self.current, torch.device(dev)
        try:
            yield
        finally:
            self.current = saved

    def current_stream(self, dev=None):
        if dev is None:
            raise AssertionError("a stream taken without naming its device")

        class Stream:
            cuda_stream = f"stream of {torch.device(dev)}"
        return Stream()

    def lib(self):
        fake = self

        class Lib:
            def __getattr__(self, symbol):
                def launch(*args):
                    fake.launches.append((symbol, fake.current, args))
                    return 0
                return launch
        return Lib()


@pytest.fixture
def fake(monkeypatch):
    f = FakeCuda(torch.device("cuda", 0))
    monkeypatch.setattr(_lib, "lib", f.lib)
    monkeypatch.setattr(torch.cuda, "device", f.device)
    monkeypatch.setattr(torch.cuda, "current_stream", f.current_stream)
    for name in _lib.KERNELS:
        monkeypatch.setitem(_lib.launch_counts, name, 0)
    return f


def test_call_enters_the_tensors_device_and_takes_its_stream(fake):
    _lib.call("seg_psum", "rt_seg_psum", torch.device("cuda", 1), 11, 22)
    assert fake.launches == [
        ("rt_seg_psum", torch.device("cuda", 1),
         (11, 22, "stream of cuda:1"))]
    assert fake.current == torch.device("cuda", 0)      # restored
    assert _lib.launch_counts["seg_psum"] == 1


def test_a_refused_launch_raises_and_is_not_counted(fake, monkeypatch):
    class Refusing:
        def __getattr__(self, symbol):
            return lambda *args: 9
    monkeypatch.setattr(_lib, "lib", lambda: Refusing())
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _lib.call("ell_spmv", "rt_ell_spmv", torch.device("cuda", 1))
    assert _lib.launch_counts["ell_spmv"] == 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape):
    return _meta(*shape, dtype=torch.int32)


S, R, W, C, L, B = 2, 8, 4, 3, 4, 1
WRAPPERS = {
    "ell_spmv": lambda: spmv_ell.ell_spmv(
        _meta(S, R, W), _i32(S, R, W), _i32(S, 3), _i32(S, 3), _meta(S, 3),
        _i32(S, R + 1), _meta(1, B, 16), _i32(S)),
    "seg_psum": lambda: spmv_seg.seg_psum(
        _meta(S, C, L), _i32(S, C, L), _meta(1, B, 16), _i32(S)),
    "seg_fixup": lambda: spmv_seg.seg_fixup(
        _meta(S, B, C, L), _i32(S, 5, 5), _i32(S, R + 1), _i32(S), _i32(S),
        num_splits=1, out=_meta(S, B, R)),
    "split_psum": lambda: spmv_split.split_psum(
        _meta(2, C, L), _i32(2, C, L), _meta(B, 16)),
    "split_combine": lambda: spmv_split.split_combine(
        _meta(S, B, 2, R), _i32(S), out=_meta(S, B, R)),
    "tile_contrib": lambda: spmv_tile.tile_contrib(
        _meta(S, 3, 8, 16), _i32(S, 3, 16), _i32(S, 3), _i32(S, 3),
        _meta(1, B, 32), _i32(S)),
    "tile_walk_spmv": lambda: spmv_tile.tile_walk_spmv(
        _meta(3, 8, 16), _i32(3), _i32(3), _meta(B, 32)),
}


@pytest.mark.parametrize("name", _lib.KERNELS)
def test_each_wrapper_launches_on_its_tensors_device(fake, name):
    WRAPPERS[name]()
    (symbol, current, args), = fake.launches
    assert current == torch.device("meta"), symbol
    assert args[-1] == "stream of meta"
    assert _lib.launch_counts[name] == 1
