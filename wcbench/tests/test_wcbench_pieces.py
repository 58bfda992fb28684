"""The copied roofline arithmetic, the draws and the benchmark file."""

import json
import math
from pathlib import Path

import pytest

from wcbench import draws, roofline

ROOT = Path(__file__).resolve().parent.parent.parent
SSY_CELL = (32, 32, 32, 384)


def test_roofline_reproduces_the_kernel_tables_ssy_bounds():
    # PERF.md's kernel table at (32, 32, 32, 384): B1's c2 product in
    # split TF32, 3 x 9.66 GFLOP at 495 TFLOP/s = 0.0586 ms; B2 fast,
    # one field read and one written, 100.7 MB at 3.35 TB/s = 0.030 ms.
    L, K, I, J = SSY_CELL
    R = L * K
    c2 = 2 * R * I * J * J
    assert roofline.bound_ms(products=c2) == pytest.approx(0.0586, abs=5e-5)
    field = 4 * R * I * J
    assert roofline.bound_ms(nbytes=2 * field) == pytest.approx(0.030,
                                                                abs=5e-4)


def test_operator_bound_counts_the_per_axis_work():
    w = roofline.operator_work(SSY_CELL)
    n = math.prod(SSY_CELL)
    assert w["products"] == 2 * n * sum(SSY_CELL)        # 12.08 GFLOP
    # 132 SMs at 1,980 MHz: products bind at 12.08 GFLOP / 165 TFLOP/s.
    b = roofline.operator_bound_ms(SSY_CELL, 132, 1980.0)
    assert b == pytest.approx(0.0732, abs=1e-4)
    gcy = roofline.operator_bound_ms((32, 16, 16, 12, 16, 16), 132, 1980.0)
    assert gcy == pytest.approx(0.0601, abs=1e-4)        # bytes bind


def test_draws_repeat_from_the_seed_and_stay_in_the_box():
    published = {"gamma": 8.89, "psi": 1.97, "beta": 0.999}
    vary = {"gamma": 0.03, "psi": 0.03}
    seed = 2 ** 31 + 12345
    take = lambda s: [next(it) for it in [draws.points(published, vary, s)]
                      for _ in range(40)]
    a, b = take(seed), take(seed)
    assert a == b
    assert take(seed + 1) != a
    for p in a:
        assert p["beta"] == 0.999
        for k, h in vary.items():
            assert abs(p[k] / published[k] - 1.0) <= h + 1e-12
    # Every seed solves the same set of points block by block: only the
    # order within a block of draws.BLOCK changes.
    key = lambda p: (p["gamma"], p["psi"])
    for s in range(20):
        other = take(s)
        for b in range(0, 40, draws.BLOCK):
            assert sorted(map(key, other[b:b + draws.BLOCK])) == \
                sorted(map(key, a[b:b + draws.BLOCK]))
    assert len(set(map(key, a))) == len(a)          # no point repeats
    # A mix's own block length.
    c = [p for p, _ in zip(draws.points(published, vary, seed, block=8),
                           range(40))]
    assert sorted(map(key, c[:8])) == sorted(map(key, a[:8]))
    assert c[:8] != a[:8]


def test_draws_reject_a_parameter_the_configuration_lacks():
    with pytest.raises(KeyError):
        next(draws.points({"gamma": 1.0}, {"psi": 0.03}, 0))


def test_benchmark_file_names_what_the_harness_finds():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = ROOT / "wcbench"
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for w in bench["workloads"]:
        assert (here / "traffic" / f"{w['traffic']}.json").is_file()
        assert (here / "cells" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (here / "metrics" / f"{m['name']}.py").is_file() or (
            here / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        # A per-layer metric is read only in cells that report what it moves.
        assert set(m["workloads"]) <= set(moved["workloads"])
