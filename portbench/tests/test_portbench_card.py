"""The benchmark's runs on the card (skipped without one): each cell
once, briefly, with its check."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run only on the card")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(card, cell):
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", cell, "--seed", "2147483999",
                        "--seconds", "4", "--trace", "0"],
                       capture_output=True, text=True, timeout=900,
                       cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
