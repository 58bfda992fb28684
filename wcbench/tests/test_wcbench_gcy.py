"""The GCY cell ``gcy.newton.draws``: the port's tiled GCY Newton path
against the reference and the TF32 control at a grid a test can hold,
the deferred kernels' work, the cell's readers and a harness run of a
throwaway GCY cell on the CPU; on the card (``-m gpu``), the cell at its
own sizes."""

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import sdfs_via_autodiff_tpu_torch as port
from sdfs_via_autodiff_tpu_torch.utils import profiling
from wcbench import catalog, check, kernel_work, run
from wcbench.spans import Spans

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
CELL = "gcy.newton.draws"
# View (2, 2, 240, 128): the (I, J) block is too large for the full
# configuration, so the deferred one runs (its plain versions on the
# CPU), as at the cell's (12, 16, 512, 256).
DEFERRED = [30, 8, 16, 2, 8, 2]
# View (4, 4, 128, 64): the full configuration; a quicker harness run.
FULL = [16, 8, 8, 4, 8, 4]
SEED = 2 ** 31 + 1234567
NEW = ("layout_ms", "deferred_b_roofline", "deferred_c_roofline")


@pytest.fixture(autouse=True)
def _recorder_off():
    """Loading a reader of the port's spans switches the recorder on:
    off and empty around each test."""
    profiling.set_recording(False)
    profiling.records()
    yield
    profiling.set_recording(False)
    profiling.records()


def _files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    config = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((HERE / "cells" / f"{CELL}.json").read_text())
    return bench, config, traffic, limits


def test_deferred_path_and_control_readings_at_a_small_grid():
    """The tiled GCY Newton path in its deferred configuration is within
    the cell's limit of the reference, and the TF32 control is not."""
    _, config, traffic, limits = _files()
    limit = limits["limits"]["logw_err"]
    config["shapes"] = DEFERRED
    params = config["params"]
    ref, _ = check.answer(config, traffic, params, device="cpu")
    with profiling.recorded() as recs:
        sol = port.wc_ratio_discrete(
            port.GCY(**params), DEFERRED, algorithm="newton",
            tol=check.tol_of(config, params), kernel=config["kernel"],
            discretization=config["discretization"], device="cpu")
    assert sol.converged
    names = [r.name for r in recs]
    n_primal = names.count("sdfs.primal")
    assert n_primal > 0
    assert sum(r.count for r in recs
               if r.name == "sdfs.primal.deferred") == n_primal
    assert check.logw_err(torch.log(sol.w_star.double()), ref) < limit
    ctl, _ = check.answer(config, traffic, params, device="cpu",
                          precision="tf32")
    assert check.logw_err(ctl, ref) > limit


def test_deferred_work_gives_the_kernel_tables_bounds():
    view = kernel_work.gcy_view((32, 16, 16, 12, 16, 16))
    assert view == (12, 16, 512, 256)
    b, c = kernel_work.deferred_b_work(view), kernel_work.deferred_c_work(
        view)
    assert b["products"] / 1e9 == pytest.approx(25.8, abs=0.05)
    assert c["flop"] / 1e9 == pytest.approx(14.3, abs=0.05)
    assert kernel_work.deferred_b_bound_ms(view) == pytest.approx(
        0.156, abs=5e-4)
    assert kernel_work.deferred_c_bound_ms(view) == pytest.approx(
        0.213, abs=5e-4)


def test_the_cell_and_its_metrics_are_declared():
    bench, config, traffic, _ = _files()
    cell = catalog.load(ROOT / "BENCHMARK.json").cell(CELL)
    assert cell.chips == 1 and traffic["algorithm"] == "newton"
    assert {m["name"] for m in cell.end_to_end} == {
        "solve_s", "peak_mem_gib", "setup_s"}
    ssy = {m["name"] for m in bench["per_layer"]
           if "ssy.newton.draws" in m.get("workloads", ())}
    assert {m["name"] for m in cell.per_layer} == ssy | set(NEW)
    for name in NEW:
        assert catalog.load(ROOT / "BENCHMARK.json").metric(name).read


class _Trace:
    """A stand-in for ``spans.Trace``: counts and device seconds by
    span name."""

    def __init__(self, counts, seconds):
        self.counts, self.seconds = counts, seconds

    def count(self, name):
        return self.counts.get(name, 0)

    def device_seconds(self, name):
        return self.seconds.get(name, 0.0)


def _record(name, start, end, n=None):
    return profiling.Record(name, 0, 0, 0, start, end, n)


def _run(deferred: int, primal: int = 33, trace=True):
    """A profiled solve 0 with ``primal`` applications, ``deferred`` of
    them in the deferred configuration, 1 ms of device time in each
    pass and 0.25 ms in each of 2,000 layout spans."""
    spans = Spans()
    spans.records["wcbench.solve"].append((0, 0.0, 10.0, None))
    recs = [_record("sdfs.primal", 1e9, 2e9)] * primal + [
        _record("sdfs.primal.deferred", 1e9, 1e9, 1)] * deferred
    trace = _Trace({"sdfs.primal.b": primal, "sdfs.primal.c": primal,
                    "sdfs.layout": 2000},
                   {"sdfs.primal.b": 1e-3 * primal,
                    "sdfs.primal.c": 1e-3 * primal,
                    "sdfs.layout": 0.5}) if trace else None
    cell = SimpleNamespace(config={"shapes": [32, 16, 16, 12, 16, 16]})
    r = run.Run(cell, [{}], spans, trace, {0} if trace else set(), {})
    r.port_records = recs
    return r


def test_the_new_readers_on_recorded_spans():
    cat = catalog.load(ROOT / "BENCHMARK.json")
    read = {name: cat.metric(name).read for name in NEW}
    got = {name: f(_run(33)) for name, f in read.items()}
    assert got["layout_ms"] == pytest.approx(0.25)
    assert got["deferred_b_roofline"] == pytest.approx(
        100 * kernel_work.deferred_b_bound_ms((12, 16, 512, 256)))
    assert got["deferred_c_roofline"] == pytest.approx(
        100 * kernel_work.deferred_c_bound_ms((12, 16, 512, 256)))
    # An application outside the deferred configuration, a port without
    # the counter, or no trace: the shares are silent.
    for r in (_run(32), _run(0), _run(33, trace=False)):
        assert read["deferred_b_roofline"](r) is None
        assert read["deferred_c_roofline"](r) is None
    assert read["layout_ms"](_run(33, trace=False)) is None


def _catalog(tmp_path: Path):
    """The benchmark's files with a throwaway GCY configuration at
    ``FULL`` and a cell ``tiny.gcy`` that takes the GCY cell's mix,
    limits and metrics and checks one solve."""
    root = tmp_path / "bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench, config, _, limits = _files()
    config["shapes"] = FULL
    (root / "configs/tiny_gcy.json").write_text(json.dumps(config))
    shutil.copy(root / "traffic/newton_draws_gcy.json",
                root / "traffic/tiny_gcy_mix.json")
    limits["solves"] = 1
    (root / "cells/tiny.gcy.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": "tiny.gcy", "config": "tiny_gcy",
                               "traffic": "tiny_gcy_mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.gcy")
    return catalog.Catalog(bench, root)


@pytest.mark.parametrize("trace", [False, True])
def test_a_harness_run_of_a_small_gcy_cell(tmp_path, trace):
    cat = _catalog(tmp_path)
    lines = []
    result, checks = run.run_cell(cat, cat.cell("tiny.gcy"), SEED, 0.0,
                                  trace, device="cpu", log=lines.append)
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] == 1
    assert checks["logw_err"]["value"] <= checks["logw_err"]["limit"]
    got = result["metrics"]
    if not trace:
        assert set(got) == {"solve_s", "peak_mem_gib", "setup_s"}
        assert got["solve_s"]["value"] > 0
    else:
        # No device on the CPU: the device-trace readers are silent, the
        # counts are not.
        assert got["outer_iters"]["value"] > 0
        assert got["krylov_iters"]["value"] > 0
        assert not set(NEW) & set(got)


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _command(trace: int, seed: int):
    proc = subprocess.run(
        [sys.executable, "-m", "wcbench.run", "--workload", CELL, "--seed",
         str(seed), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.gpu
def test_the_cell_runs_on_the_card_and_is_correct():
    _card()
    line, _ = _command(0, 2 ** 31 + 5)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"solve_s", "peak_mem_gib", "setup_s"}


@pytest.mark.gpu
def test_the_control_in_the_programs_place_fails_the_cell(monkeypatch):
    _card()
    monkeypatch.chdir(ROOT)
    cat = catalog.load()
    cell = cat.cell(CELL)
    control = check.control_solver(cell.config, cell.traffic, device="cuda")
    lines = []
    result, checks = run.run_cell(cat, cell, 2 ** 31 + 17, 1.0, False,
                                  log=lines.append, solve=control)
    print("\n".join(lines))
    assert result["correct"] is False
    assert checks["logw_err"]["value"] > checks["logw_err"]["limit"]


@pytest.mark.gpu
def test_a_traced_run_reports_the_layout_and_the_deferred_shares():
    _card()
    line, err = _command(1, 2 ** 31 + 29)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["layout_ms"] > 0, err[-4000:]
    for name in ("deferred_b_roofline", "deferred_c_roofline"):
        assert 0 < got[name] <= 100, (name, got[name])
