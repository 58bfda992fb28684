"""Readings for the limits of ``correct``: the numbers compared for the
program and for the control, over many seeds, in one process.

    python3 -m wcbench.calibrate --workload <name> --seeds 1,2,... \
        [--points 2] [--window 32] [--control] [--program 0|1]

For each seed, ``--points`` of the first ``--window`` parameter points
of the cell's traffic (chosen by the seed, as a run samples its window's
solves) are solved by the timed call, after one warm-up solve, and
judged by the run's own comparison (``check.numbers`` and
``check.judge`` against the cell's limits); with ``--control`` the
control (``check.control_solver``: the reference one precision below)
takes the program's place at the same points and is judged the same
way.  One JSON line per reading with its verdict, then the largest and
smallest of each number on each side.  The benchmark's runs never run
this.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m wcbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--points", type=int, default=2)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", type=int, default=1)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from . import check, draws
    from .catalog import load
    from .run import PORT, Device, _solver

    cell = load().cell(args.workload)
    if not torch.cuda.is_available():
        print("wcbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    config, traffic = cell.config, cell.traffic
    limits = cell.check["limits"]
    dev = Device(torch, "cuda")
    sides = {}
    if args.program:
        sides["program"] = _solver(__import__(PORT), config, traffic, dev)
        sides["program"](dict(config["params"]))
    if args.control:
        sides["control"] = check.control_solver(config, traffic,
                                                device="cuda")
    seen = {side: [] for side in sides}
    for seed in (int(s) for s in args.seeds.split(",")):
        pts = list(itertools.islice(
            draws.points(dict(config["params"]), traffic["vary"], seed,
                         traffic.get("block", draws.BLOCK)),
            args.window))
        picks = sorted(np.random.default_rng(seed % 2 ** 64).choice(
            args.window, args.points, replace=False))
        for k in picks:
            params = pts[k]
            for side, solve in sides.items():
                row = {"side": side, "seed": seed, "point": int(k),
                       "gamma": params["gamma"], "psi": params["psi"]}
                t0 = time.perf_counter()
                sol = solve(params)
                dev.sync()
                row["solve_s"] = time.perf_counter() - t0
                row["iterations"] = int(sol.result.iterations)
                row["converged"] = bool(sol.converged)
                log_w = torch.log(sol.w_star.double())
                del sol
                t0 = time.perf_counter()
                r = check.numbers(config, traffic, params, log_w,
                                  row["iterations"], device="cuda")
                dev.sync()
                row["check_s"] = time.perf_counter() - t0
                _, ok = check.judge([r], limits)
                row.update(r, correct=ok)
                seen[side].append(row)
                del log_w
                torch.cuda.empty_cache()
                print(json.dumps(row), flush=True)
    for side, rows in seen.items():
        if not rows:
            continue
        summary = {"n": len(rows),
                   "correct": sum(r["correct"] for r in rows)}
        for name in rows[0]:
            if name in limits or name == "early_stop_step":
                vals = [r[name] for r in rows]
                summary[name] = {"max": max(vals), "min": min(vals),
                                 "limit": limits.get(name)}
        print(json.dumps({side: summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
