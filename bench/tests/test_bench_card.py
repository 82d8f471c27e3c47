"""Card tests of the benchmark: ``python -m pytest -q -m cuda bench/tests``.

At a size a test run holds (a twentieth of each configuration), on the
card: every cell's run through the graphed executor or the router reads
correct, and the control (the reference in bfloat16 in the program's
place) reads above each configuration's limit where the program's
answers read below it.  Each test decides inside itself whether there
is a card.
"""
from __future__ import annotations

import contextlib
import io
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from benchlib import cell  # noqa: E402

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
SCALE = 0.05


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the graphed executor and the "
                    "kernels run only there)")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reads_correct_on_the_card(workload):
    _card()
    out = cell.run_cell(workload, 2**31 + 7, 0.5, True, device="cuda",
                        scale=SCALE)
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_the_control_fails_where_the_program_passes(config):
    _card()
    import control
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        control.main(["--config", config, "--seconds", "0.5", "--scale",
                      str(SCALE), "--seeds", "11", "12", "13"])
    rows = [r for r in map(json.loads, buf.getvalue().splitlines())
            if "cell" in r]
    assert rows
    for r in rows:
        assert r["program"] <= r["limit"] < r["control"], r
