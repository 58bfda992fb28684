"""What a run needs, found by name.

``BENCHMARK.json`` at the root lists the cells and metrics.  Everything
that belongs to one configuration, traffic mix, cell or per-layer metric
is a file of its own under this folder, found by the name the cell or
metric gives:

    configs/<config>.json     model, parameters, grid, operator, tol rule
    traffic/<traffic>.json    solver and the parameter draws
    cells/<workload>.json     the correctness check: solves and limits
    metrics/<metric>.py       LAYER, UNIT, MOVES, SOURCE, WRAPS, read(run)

A metric named ``<metric>.<split>`` is the same quantity read in cells
that report another end-to-end metric (``solve_s.sa``, the SA cells'
seconds a solve, under a bound of its own; ``outer_iters.sa``, which
moves it): without a file of its own it reads with
``metrics/<metric>.py``, and an end-to-end metric so named takes the
value of ``<metric>``.  A later cell, mix or metric is a new file and a
new entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Optional

__all__ = ["HERE", "Catalog", "Cell", "load"]

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list        # BENCHMARK.json entries that apply to the cell
    per_layer: list


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Catalog:
    benchmark: dict
    root: Path = HERE       # where configs/, traffic/, cells/, metrics/ are

    def cell(self, workload: str) -> Cell:
        entry = next((w for w in self.benchmark["workloads"]
                      if w["name"] == workload), None)
        if entry is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        return Cell(
            name=workload, chips=int(entry["chips"]),
            config=_json(self.root / "configs" / f"{entry['config']}.json"),
            traffic=_json(self.root / "traffic" / f"{entry['traffic']}.json"),
            check=_json(self.root / "cells" / f"{workload}.json"),
            end_to_end=[m for m in self.benchmark["end_to_end"]
                        if _applies(m, workload)],
            per_layer=[m for m in self.benchmark["per_layer"]
                       if _applies(m, workload)])

    def metric(self, name: str) -> ModuleType:
        """The reader module ``metrics/<name>.py``, or for a split name
        ``<base>.<split>`` without a file of its own, ``<base>.py``."""
        path = self.root / "metrics" / f"{name}.py"
        if not path.is_file():
            path = self.root / "metrics" / f"{name.split('.')[0]}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no metric reader for {name!r} in "
                                    f"{path.parent}")
        spec = importlib.util.spec_from_file_location(
            f"wcbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr in ("LAYER", "UNIT", "MOVES", "SOURCE", "WRAPS", "read"):
            if not hasattr(mod, attr):
                raise AttributeError(f"metric reader {path} lacks {attr}")
        return mod


def load(benchmark: Optional[Path] = None, root: Path = HERE) -> Catalog:
    """The catalog of ``benchmark`` (default: ``BENCHMARK.json`` in the
    working directory, the checkout's root)."""
    path = Path(benchmark) if benchmark else Path.cwd() / "BENCHMARK.json"
    return Catalog(benchmark=_json(path), root=Path(root))
