"""The cells on the card (each skips without one):
``python -m pytest -m gpu wcbench/tests/test_wcbench_card.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.gpu
def test_a_cell_runs_on_the_card_and_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "wcbench.run", "--workload",
         "ssy.newton.draws", "--seed", str(2 ** 31 + 5), "--seconds", "2",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"solve_s", "peak_mem_gib", "setup_s"}
    assert proc.stderr.strip().splitlines()[-1].startswith("check logw_err")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ssy.newton.draws", "ssy.sa.draws"])
def test_the_control_in_the_programs_place_fails_the_cell(workload,
                                                          monkeypatch):
    """A run of the cell at its own sizes with the TF32 control in the
    timed call's place, judged by the run's own comparison."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wcbench import check, run
    from wcbench.catalog import load
    monkeypatch.chdir(ROOT)
    cat = load()
    cell = cat.cell(workload)
    control = check.control_solver(cell.config, cell.traffic, device="cuda")
    lines = []
    result, checks = run.run_cell(cat, cell, 2 ** 31 + 17, 1.0, False,
                                  log=lines.append, solve=control)
    print("\n".join(lines))
    assert result["correct"] is False
    assert checks["logw_err"]["value"] > checks["logw_err"]["limit"]
