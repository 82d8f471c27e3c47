"""Rehearsal sizes of configurations added after the harness's tests were
written: each CPU rehearsal reads its configuration's size from the test
module's ``SCALE``, so the sizes of later configurations are given here,
beside the ones the module lists itself."""
import pytest

#: Configuration -> the share of its rows a CPU rehearsal keeps.
LATER_SCALES = {"powerlaw_tail": 1 / 64}      # 16,384 rows, ~280 k nnz


@pytest.fixture(autouse=True)
def _later_rehearsal_scales(request, monkeypatch):
    scale = getattr(request.module, "SCALE", None)
    if isinstance(scale, dict):
        for name, s in LATER_SCALES.items():
            monkeypatch.setitem(scale, name, s)
