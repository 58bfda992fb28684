"""The port's span and counter recorder (``utils/profiling.py``): what it
records off and on, the counts its spans give on tiny solves, their
roots, their place in a ``torch.profiler`` trace, and the benchmark's
readers of them (``wcbench/metrics/``) in tiny harness runs.

A test marked ``gpu`` (skipped without a card) holds the ``sdfs.sync``
spans of one solver call to the synchronizing calls that
``torch.cuda.set_sync_debug_mode("warn")`` reports: every blocking host
read of the loops goes through ``solvers/krylov.host_read``.
"""

import json
import math
import shutil
import traceback
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu_torch.solvers import fixed_point
from sdfs_via_autodiff_tpu_torch.solvers.krylov import SYNC_EVERY
from sdfs_via_autodiff_tpu_torch.utils import profiling as prof

SHAPES = (4, 4, 4, 6)
TOL = 2e-5
ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 7
NEW_METRICS = ("build_ms", "host_syncs", "sync_wait_ms", "primal_host_us")
# Readers that switch the port's recorder on: left out of a run without
# the port's span readers.
RECORDERS = NEW_METRICS + ("krylov_fused_share",)


@pytest.fixture(autouse=True)
def _recorder_off():
    """One intra-op thread (solver loops run thousands of small ops), and
    the recorder off and empty around each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    prof.set_recording(False)
    prof.records()
    yield
    prof.set_recording(False)
    prof.records()
    torch.set_num_threads(n)


def _solve(algorithm, device="cpu", **kw):
    return P.wc_ratio_discrete(P.SSY(), SHAPES, algorithm=algorithm,
                               tol=TOL, kernel="tiled", device=device, **kw)


def _names(recs) -> Counter:
    return Counter(r.name for r in recs)


def test_recording_off_records_nothing_through_one_shared_object():
    assert not prof.is_recording()
    assert prof.span("sdfs.a") is prof.span("sdfs.b")
    with prof.span("sdfs.a"):
        prof.count("sdfs.a", 3)
    _solve("sa")
    assert prof.records() == []


def test_spans_nest_and_counts_land_on_their_span():
    with prof.recorded() as recs:
        with prof.span("outer"):
            with prof.span("inner"):
                prof.count("inner", 2)
                prof.count("inner", 3)
            prof.count("point", 7)
    by = {r.name: r for r in recs}
    assert [r.name for r in recs] == ["inner", "point", "outer"]
    assert by["inner"].count == 5 and by["outer"].count is None
    assert by["inner"].parent == by["outer"].id == by["outer"].root
    assert by["point"].count == 7 and by["point"].parent == by["outer"].id
    assert by["point"].start_ns == by["point"].end_ns
    assert by["outer"].start_ns <= by["inner"].start_ns
    assert by["inner"].end_ns <= by["outer"].end_ns
    assert not prof.is_recording() and prof.records() == []


def test_sa_solve_counts_its_primals_and_host_reads():
    with prof.recorded() as recs:
        sol = _solve("sa")
    assert sol.converged
    its = sol.result.iterations
    chunks = math.ceil(its / SYNC_EVERY)
    n = _names(recs)
    assert n["sdfs.primal"] == SYNC_EVERY * chunks
    # A read per chunk run, the read that ends the loop, and the three
    # reads of the result (converged, iterations, residual).
    assert n["sdfs.sync"] == chunks + 1 + 3
    assert n["sdfs.krylov"] == n["sdfs.newton.step"] == 0
    for name in ("sdfs.solve", "sdfs.build", "sdfs.build.discretize",
                 "sdfs.build.operands", "sdfs.build.upload"):
        assert n[name] == 1, name


def test_newton_counts_krylov_iterations_per_step(monkeypatch):
    returned = []
    real = fixed_point.bicgstab_mixed

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        returned.append(out[1])
        return out
    monkeypatch.setattr(fixed_point, "bicgstab_mixed", spy)
    with prof.recorded() as recs:
        sol = _solve("newton", discretization="tauchen")
    assert sol.converged
    krylov = [r.count for r in recs if r.name == "sdfs.krylov"]
    assert krylov == returned
    # Frozen steps (after the stop condition failed inside a chunk) make
    # no Krylov iteration and build no tangent.
    assert 0 in krylov and all(k > 0 for k in krylov[:sol.result.iterations])
    n = _names(recs)
    assert n["sdfs.newton.step"] == len(krylov)
    assert n["sdfs.tangent.build"] == sum(k > 0 for k in krylov)
    steps = {r.id for r in recs if r.name == "sdfs.newton.step"}
    assert all(r.parent in steps for r in recs if r.name == "sdfs.krylov")


def test_every_record_has_its_solves_root():
    with prof.recorded() as recs:
        _solve("sa")
        _solve("newton")
    roots = [r for r in recs if r.name == "sdfs.solve"]
    assert len(roots) == 2 and all(r.root == r.id for r in roots)
    for root in roots:
        mine = [r for r in recs if r.root == root.id]
        ids = {r.id for r in mine}
        assert all(r.parent in ids for r in mine if r is not root)
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
                   for r in mine)
    assert {r.root for r in recs} == {r.id for r in roots}


def test_spans_are_annotations_of_the_profilers_trace(tmp_path):
    with prof.recorded() as recs:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            # The profiler's first annotation costs a millisecond: as in
            # the harness, the port's spans come after one.
            with torch.profiler.record_function("warm"):
                pass
            with prof.span("anchor"):
                _solve("newton")
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] != "warm":
            ann.setdefault(e["name"], []).append(float(e["ts"]))
    assert Counter({k: len(v) for k, v in ann.items()}) == _names(recs)
    (anchor,) = ann.pop("anchor")
    # The trace's clock (us) against the recorder's (ns): one offset,
    # taken at the root, maps every span's start to its annotation.
    (root,) = [r for r in recs if r.name == "anchor"]
    offset = anchor - 1e-3 * root.start_ns
    for name, starts in ann.items():
        mine = sorted(1e-3 * r.start_ns + offset for r in recs
                      if r.name == name)
        assert np.max(np.abs(np.array(mine) - np.sort(starts))) < 1e3, name


# ---------------------------------------------------------------- harness

SMALL = [8, 8, 16, 64]
# Seeds whose runs profile the window's second solve and its first.
# With --seconds 0 the window is one solve: untraced, then traced.
SEED_UNTRACED, SEED_TRACED = 2 ** 31 + 7, 2 ** 31 + 8


def _catalog(tmp_path: Path, algorithm: str, metrics=True, probe=False):
    """The benchmark's files with a throwaway configuration at ``SMALL``
    and a cell ``tiny.cell`` that takes the metrics of the Newton or SA
    cell (without the port's span readers unless ``metrics``) and checks
    one solve; ``probe`` adds a metric that keeps the run's trace on the
    harness's module for the test to read."""
    from wcbench import catalog
    root = tmp_path / "bench"
    shutil.copytree(ROOT / "wcbench", root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((root / "configs/ssy_tauchen_12.6M.json").read_text())
    cfg["shapes"] = SMALL
    (root / "configs/tiny_ssy.json").write_text(json.dumps(cfg))
    mix, cell = {"newton": ("newton_draws", "ssy.newton.draws"),
                 "sa": ("sa_draws", "ssy.sa.draws")}[algorithm]
    shutil.copy(root / f"traffic/{mix}.json", root / "traffic/tiny_mix.json")
    limits = json.loads((root / f"cells/{cell}.json").read_text())
    limits["solves"] = 1
    (root / "cells/tiny.cell.json").write_text(json.dumps(limits))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny_ssy",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell in m.get("workloads", ()):
            if metrics or m["name"].split(".")[0] not in RECORDERS:
                m["workloads"].append("tiny.cell")
    if probe:
        (root / "metrics/tiny_probe.py").write_text(PROBE)
        bench["per_layer"].append({
            "name": "tiny_probe", "unit": "count", "better": "lower",
            "source": "device_trace", "layer": "Device", "moves": "solve_s",
            "workloads": ["tiny.cell"]})
    return catalog.Catalog(bench, root)


PROBE = '''
LAYER = "Device"
UNIT = "count"
MOVES = "solve_s"
SOURCE = "device_trace"
WRAPS = ()


def read(run):
    import wcbench.run
    wcbench.run.PROBED_TRACE = run.trace
'''


def _run(cat, seed, trace=True):
    from wcbench import run
    result, _ = run.run_cell(cat, cat.cell("tiny.cell"), seed, 0.0, trace,
                             device="cpu", log=lambda s: None)
    assert result["attempted"] == 1
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("algorithm", ["newton", "sa"])
def test_a_traced_run_reports_the_port_span_metrics(tmp_path, algorithm):
    split = "" if algorithm == "newton" else ".sa"
    got = _run(_catalog(tmp_path, algorithm), SEED_UNTRACED)
    for name in NEW_METRICS:
        assert got[name + split] > 0, (name, got)
    syncs, outer = got["host_syncs" + split], got["outer_iters" + split]
    if algorithm == "newton":
        # Per Newton step at least a Krylov solve's last read and its
        # count; the outer loop's reads as in SA.
        assert syncs >= 2 * outer + math.ceil(outer / SYNC_EVERY) + 1 + 3
    else:
        assert syncs == math.ceil(outer / SYNC_EVERY) + 1 + 3


def test_port_spans_match_the_harness_spans_in_the_trace(tmp_path):
    """The port's spans and the harness's wraps annotate the same calls,
    and the solver counts read the same with the recorder on and off."""
    import wcbench.run
    off = _run(_catalog(tmp_path / "off", "newton", metrics=False),
               SEED_TRACED)
    assert not prof.is_recording()
    on = _run(_catalog(tmp_path / "on", "newton", probe=True), SEED_TRACED)
    assert prof.is_recording()
    trace = wcbench.run.__dict__.pop("PROBED_TRACE")
    assert trace.count("sdfs.primal") == trace.count("port.primal") > 0
    assert (trace.count("sdfs.tangent.matvec")
            == trace.count("port.tangent.matvec") > 0)
    assert (trace.count("sdfs.tangent.build")
            == trace.count("port.tangent.build") > 0)
    assert trace.count("sdfs.krylov") == trace.count("port.krylov") > 0
    assert "host_syncs" not in off and on["host_syncs"] > 0
    # The one solve is traced: the readers of untraced solves are silent.
    assert "build_ms" not in on
    for name in ("krylov_iters", "outer_iters"):
        assert on[name] == off[name], name


def test_an_untraced_run_loads_no_reader_and_records_nothing(tmp_path):
    got = _run(_catalog(tmp_path, "sa"), SEED_UNTRACED, trace=False)
    assert set(got) == {"solve_s.sa", "peak_mem_gib", "setup_s"}
    assert not prof.is_recording() and prof.records() == []


# ------------------------------------------------------------------ card

@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["successive_approx", "newton"])
def test_host_reads_are_the_synchronizing_calls_of_a_solve(algorithm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disc = P.discretize_ssy(P.SSY(), (8, 8, 16, 64), method="tauchen")
    T = P.make_tiled_T_log_ssy(P.SSY(), disc, device="cuda")
    x0 = torch.full((8, 8, 16, 64), math.log(800.0), device="cuda")
    P.solve(T, x0, method=algorithm, tol=TOL)       # built and warm
    torch.cuda.synchronize()
    stacks = []

    def seen(message, *args, **kwargs):
        if "synchroniz" in str(message):
            stacks.append([f for f in traceback.extract_stack()[:-1]
                           if not f.filename.endswith("warnings.py")])
    torch.cuda.set_sync_debug_mode("warn")     # may warn on its own
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            with prof.recorded() as recs:
                res = P.solve(T, x0, method=algorithm, tol=TOL)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.converged
    # Where a read escaped the helper: the innermost frames of its stack.
    escaped = Counter(" < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                 for f in reversed(st[-4:]))
                      for st in stacks if st[-1].name != "host_read")
    assert len(stacks) == _names(recs)["sdfs.sync"] > 0, escaped
