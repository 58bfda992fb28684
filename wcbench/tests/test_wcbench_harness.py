"""The harness driven end to end on the CPU at a small grid, from files
placed in a temporary directory: discovery, the result line, the check
failing under planted faults, and the import rule."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sdfs_via_autodiff_tpu_torch as port
from wcbench import catalog, check, run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
SMALL = [8, 8, 16, 64]
SEED = 2 ** 31 + 99


def _catalog(tmp_path: Path, metric_file: str = None, algorithm="newton"):
    """A copy of the benchmark's files with a throwaway configuration,
    traffic mix, cell and (optionally) metric that no existing file
    names; ``algorithm`` "sa" takes the SA cell's mix and limits."""
    root = tmp_path / "bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((root / "configs/ssy_tauchen_12.6M.json").read_text())
    cfg["shapes"] = SMALL
    (root / "configs/tiny_ssy.json").write_text(json.dumps(cfg))
    mix, cell = {"newton": ("newton_draws", "ssy.newton.draws"),
                 "sa": ("sa_draws", "ssy.sa.draws")}[algorithm]
    traffic = json.loads((root / f"traffic/{mix}.json").read_text())
    (root / "traffic/tiny_newton.json").write_text(json.dumps(traffic))
    limits = json.loads((root / f"cells/{cell}.json").read_text())
    (root / "cells/tiny.cell.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny_ssy",
                               "traffic": "tiny_newton", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", ()):     # the metrics of its cell
            m["workloads"].append("tiny.cell")
    if metric_file:
        (root / "metrics/tiny_metric.py").write_text(metric_file)
        bench["per_layer"].append({
            "name": "tiny_metric", "unit": "count", "better": "lower",
            "source": "program_counter", "layer": "Outer solver",
            "moves": "solve_s", "workloads": ["tiny.cell"]})
    return catalog.Catalog(bench, root)


def _run(cat, trace=False, seconds=0.5, solve=None):
    lines = []
    result, checks = run.run_cell(cat, cat.cell("tiny.cell"), SEED, seconds,
                                  trace, device="cpu", log=lines.append,
                                  solve=solve)
    return result, checks, lines


TINY_METRIC = '''
LAYER = "Outer solver"
UNIT = "count"
MOVES = "solve_s"
SOURCE = "program_counter"
WRAPS = ({"module": "sdfs_via_autodiff_tpu_torch",
          "attr": "wc_ratio_discrete", "span": "tiny.driver"},)


def read(run):
    return float(len(run.spans.of("tiny.driver")))
'''


def test_new_files_are_found_and_the_line_has_its_schema(tmp_path):
    cat = _catalog(tmp_path, TINY_METRIC)
    result, checks, lines = _run(cat, trace=True)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    # The throwaway metric wrapped the driver once per solve and the
    # warm-up.
    assert result["metrics"]["tiny_metric"]["value"] == \
        result["attempted"] + 1
    assert result["metrics"]["outer_iters"]["unit"] == "count"
    assert set(checks) == {"logw_err"}
    assert checks["logw_err"]["value"] <= checks["logw_err"]["limit"]
    json.dumps(result)
    # The wraps are gone once the run ends.
    assert not hasattr(port.wc_ratio_discrete, "__wrapped__")
    assert run.forbidden_modules() == []


def test_end_to_end_metrics_of_a_plain_run(tmp_path):
    cat = _catalog(tmp_path)
    result, _, _ = _run(cat)
    assert set(result["metrics"]) == {"solve_s", "peak_mem_gib", "setup_s"}
    assert result["metrics"]["solve_s"]["value"] > 0


def test_an_sa_cell_reports_its_split_metrics(tmp_path):
    """The SA cell's seconds a solve and its per-layer metrics carry the
    ``.sa`` split and read with the unsplit readers."""
    cat = _catalog(tmp_path, algorithm="sa")
    cell = cat.cell("tiny.cell")
    assert {m["name"] for m in cell.end_to_end} == {
        "solve_s.sa", "peak_mem_gib", "setup_s"}
    assert {m["moves"] for m in cell.per_layer} == {"solve_s.sa"}
    assert cat.metric("outer_iters.sa").read is not None
    result, _, _ = _run(cat, trace=True, seconds=0.1)
    assert "outer_iters.sa" in result["metrics"]
    assert "krylov_iters" not in result["metrics"]
    with pytest.raises(FileNotFoundError):
        cat.metric("no_such_metric.sa")


def _fault_operator(kind):
    """Wrap the SSY factory so that its operator is broken."""
    real = port.drivers.make_tiled_T_log_ssy

    def factory(*args, **kwargs):
        T = real(*args, **kwargs)
        if kind == "unchanged":
            def broken(ell):
                return ell.clone()
        else:                                   # half the grid left out
            def broken(ell):
                out = T(ell)
                half = ell.shape[0] // 2
                out[half:] = ell[half:]
                return out
        broken.__dict__.update(T.__dict__)
        return broken
    return factory


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    cat = _catalog(tmp_path)
    if fault == "answer_altered":
        real = port.wc_ratio_discrete

        def altered(*args, **kwargs):
            sol = real(*args, **kwargs)
            sol.w_star.view(-1)[7] *= 1.01
            return sol
        monkeypatch.setattr(port, "wc_ratio_discrete", altered)
    else:
        monkeypatch.setattr(port.drivers, "make_tiled_T_log_ssy",
                            _fault_operator("unchanged" if fault ==
                                            "unchanged" else "half"))
    result, checks, _ = _run(cat, seconds=0.1)
    assert result["correct"] is False
    assert checks["logw_err"]["value"] > checks["logw_err"]["limit"]


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    """The TF32 control answers for the timed call inside a run and the
    run's own comparison fails it (at the cells' sizes: the card test)."""
    cat = _catalog(tmp_path)
    cell = cat.cell("tiny.cell")
    control = check.control_solver(cell.config, cell.traffic, device="cpu")
    result, checks, _ = _run(cat, seconds=0.1, solve=control)
    assert result["correct"] is False and result["failed"] == 0
    assert checks["logw_err"]["value"] > checks["logw_err"]["limit"]


def test_an_sa_run_is_correct_and_an_early_stop_is_not(tmp_path,
                                                       monkeypatch):
    """SA is judged at the count it reports, and by the reference's own
    step there: a solve that stops early while it says it converged
    (here: at 30 times the tolerance) fails ``stop_step``."""
    cat = _catalog(tmp_path, algorithm="sa")
    result, checks, lines = _run(cat, seconds=0.1)
    assert result["correct"] is True, lines
    assert set(checks) == {"logw_err", "stop_step"}
    assert 0.9 < checks["stop_step"]["value"] <= checks["stop_step"][
        "limit"]
    real = port.wc_ratio_discrete

    def early(*args, **kwargs):
        kwargs["tol"] *= 30
        return real(*args, **kwargs)
    monkeypatch.setattr(port, "wc_ratio_discrete", early)
    result, checks, _ = _run(cat, seconds=0.1)
    assert result["correct"] is False
    assert checks["stop_step"]["value"] > 20


def test_judge_takes_the_worst_reading_of_each_number():
    limits = {"logw_err": 1e-4, "stop_step": 1.2}
    ok = [{"logw_err": 5e-5, "stop_step": 1.01},
          {"logw_err": 9e-5, "stop_step": 0.98, "early_stop_step": 9.0}]
    checks, correct = check.judge(ok, limits)
    assert correct is True
    assert checks == {"logw_err": {"value": 9e-5, "limit": 1e-4},
                      "stop_step": {"value": 1.01, "limit": 1.2}}
    assert check.judge(ok + [{"logw_err": 1e-5, "stop_step": 1.3}],
                       limits)[1] is False
    assert check.judge(ok + [{"logw_err": float("nan"), "stop_step": 1}],
                       limits)[1] is False
    assert check.judge([], limits)[1] is False
    with pytest.raises(KeyError):
        check.judge(ok, {"no_such_number": 1.0})


def test_a_missing_wrap_target_fails_loudly(tmp_path):
    bad = TINY_METRIC.replace('"wc_ratio_discrete"', '"no_such_function"')
    cat = _catalog(tmp_path, bad)
    with pytest.raises(AttributeError, match="no_such_function"):
        _run(cat, trace=True)


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "wcbench.run", "--workload",
         "ssy.newton.draws", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, wcbench.run, wcbench.calibrate, wcbench.check, "
            "sdfs_via_autodiff_tpu_torch;"
            "from wcbench.run import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    assert out.strip() == "[]"


def test_the_forbidden_names_compare_whole(monkeypatch):
    assert "sdfs_via_autodiff_tpu_torch" in sys.modules
    assert "sdfs_via_autodiff_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sdfs_via_autodiff_tpu.models", sys)
    assert "sdfs_via_autodiff_tpu" in run.forbidden_modules()
