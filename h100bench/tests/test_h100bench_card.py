"""On the card: each cell's run, sound and with the control in the
program's place, as the benchmark's command runs it. Skips where no CUDA
card is present (the fixture decides, never the import).

    python -m pytest -m cuda h100bench/tests/test_h100bench_card.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(cell, seed, *extra):
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", "4", "--trace", "0", *extra], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(card, cell):
    assert _run(cell, 2**31 + 5)["correct"]
    assert not _run(cell, 2**31 + 6, "--control")["correct"]
