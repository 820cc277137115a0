"""On the card: each one-card cell runs end to end with ``correct`` true,
and its control (the reference at float8 in the system's place) at the
cell's own size reads not correct. Marked ``gpu``; each test decides for
itself whether a card is there and skips without one.

    python3 -m pytest -m gpu portbench/tests/test_portbench_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
ONE_CARD = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
            if c["chips"] == 1]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct(cell):
    _need_card()
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 101), "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_at_cell_size_is_not_correct(cell):
    _need_card()
    import torch
    found = harness.find_cell(ROOT, cell)
    ctx = harness.Ctx(found, 2 ** 31 + 103, 1.0, False, torch.device("cuda", 0))
    checks = harness.mode(found["mix"]).control(ctx, "fp8")
    assert not harness.verdict(found["limits"], [checks])[0]
