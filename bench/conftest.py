"""The rehearsal size of the blocked_band configuration: each CPU
rehearsal reads its configuration's size from the test module's
``SCALE``, so this adds it there, beside the sizes ``bench/tests`` gives."""
import pytest

#: Configuration -> the share of its rows a CPU rehearsal keeps.  At 1/64,
#: 4,096 rows and 873,840 nonzeros: the band again ends at row M / 2.
BLOCKED_BAND_SCALES = {"blocked_band": 1 / 64}


@pytest.fixture(autouse=True)
def _blocked_band_rehearsal_scale(request, monkeypatch):
    scale = getattr(request.module, "SCALE", None)
    if isinstance(scale, dict):
        for name, s in BLOCKED_BAND_SCALES.items():
            monkeypatch.setitem(scale, name, s)
