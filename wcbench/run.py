"""Run one cell of the benchmark once and print its result line.

    python3 -m wcbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  In order: start-up (torch, the port, its
CUDA libraries, built by the port into its own ``_build/`` at a
checkout's first run); one untimed solve at the configuration's
published point; the window; the correctness check; one JSON line.

The window is a closed loop with one client: each parameter point of the
traffic (``draws.py``) gets a fresh ``wc_ratio_discrete`` call ending in
``torch.cuda.synchronize()``, and the next starts when it returns.
Solves start while less than ``--seconds`` has passed since the first
began; every started solve runs to its end and counts.  The window runs
from the first solve's start to the last one's end.

``--trace 0`` reports the cell's end-to-end metrics: ``solve_s`` (window
over solves), ``peak_mem_gib`` (the largest, over the solves, of the
device memory a solve allocated at its peak beyond what was allocated
when it began) and ``setup_s`` (process start to the window's start).
``--trace 1`` installs the per-layer metrics' spans, profiles one solve
of the window (the seed picks the first or the second) and reports the
per-layer metrics and a breakdown of that solve.

The process exits non-zero, printing no result, without enough CUDA
devices, and when JAX or the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import tempfile
import time

__all__ = ["main", "run_cell", "FORBIDDEN"]

FORBIDDEN = ("jax", "jaxlib", "flax", "sdfs_via_autodiff_tpu")
PORT = "sdfs_via_autodiff_tpu_torch"
SOLVE_SPAN = "wcbench.solve"
GIB = float(2 ** 30)
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, on the boot-time clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the latter)."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


class Device:
    """The card's clock and memory calls, or their stand-ins on the CPU
    (the tests' runs, which report no device number)."""

    def __init__(self, torch, device: str):
        self.torch, self.name = torch, device
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def allocated(self) -> int:
        return self.torch.cuda.memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def describe(self, chips: int) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 0}
        import subprocess
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=60, check=True)
        power, clock = (float(x) for x in q.stdout.split(","))
        props = self.torch.cuda.get_device_properties(0)
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0), "count": chips,
                "power_limit_w": power, "sm_count": props.multi_processor_count,
                "sm_clock_max_mhz": clock}


class Run:
    """What a per-layer metric reads: the window's solves, the spans,
    the trace of the profiled solve and the cell."""

    def __init__(self, cell, solves, spans, trace, traced, device):
        self.cell, self.solves, self.spans = cell, solves, spans
        self.trace, self.traced, self.device = trace, traced, device

    @property
    def untraced(self) -> set:
        return set(range(len(self.solves))) - self.traced


def _wraps(readers) -> list:
    seen, out = set(), []
    for r in readers.values():
        for w in r.WRAPS:
            key = (w["module"], w["attr"], w["span"], w.get("on", "call"))
            if key not in seen:
                seen.add(key)
                out.append(w)
    return out


def _solver(port, config: dict, traffic: dict, dev: Device):
    from .check import tol_of
    model_cls = getattr(port, config["model"])
    shapes = tuple(config["shapes"])
    opts = dict(traffic.get("solver_options", {}))

    def solve(params):
        sol = port.wc_ratio_discrete(
            model_cls(**params), shapes, algorithm=traffic["algorithm"],
            tol=tol_of(config, params), kernel=config["kernel"],
            discretization=config["discretization"], device=dev.name,
            **opts)
        dev.sync()
        return sol
    return solve


def _profiler(torch, dev: Device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(catalog, cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", log=print, solve=None):
    """One run of ``cell``: (result dict, checks dict).  ``log`` takes
    the lines for standard error.  ``solve`` (params -> an answer with
    ``w_star``, ``converged`` and ``result.iterations``) stands in for
    the timed call: the control, or a broken path in a test."""
    import numpy as np
    import torch

    from . import check, draws
    from .spans import Spans

    port = __import__(PORT)
    dev = Device(torch, device)
    config, traffic = cell.config, cell.traffic
    readers = ({m["name"]: catalog.metric(m["name"]) for m in cell.per_layer}
               if trace else {})
    spans = Spans()
    for w in _wraps(readers):
        spans.install(w)
    try:
        if solve is None:
            solve = _solver(port, config, traffic, dev)
        published = dict(config["params"])
        warm = solve(published)
        log(f"wcbench: warm-up at the published point: converged "
            f"{warm.converged}, {warm.result.iterations} iterations")
        del warm
        rng = np.random.default_rng(int(seed) % 2 ** 64 + 1)
        trace_at = int(rng.integers(0, 2)) if trace else -1
        if trace:       # the profiler's own start-up stays out of the window
            with _profiler(torch, dev):
                torch.zeros(1, device=device).add_(1)
                dev.sync()
        peak_abs = dev.peak()
        points = draws.points(published, traffic["vary"], seed,
                              traffic.get("block", draws.BLOCK))
        n_keep = int(cell.check["solves"])
        kept, solves, prof = [], [], None
        t_first = t_last = setup_s = None
        while t_first is None or time.perf_counter() - t_first < seconds:
            params = next(points)
            i = len(solves)
            base = dev.allocated()
            dev.reset_peak()
            if i == trace_at:
                prof = _profiler(torch, dev)
                prof.start()
            spans.solve = i
            t0 = time.perf_counter()
            if t_first is None:
                t_first, setup_s = t0, process_age()
            with spans.span(SOLVE_SPAN):
                sol = solve(params)
            t_last = time.perf_counter()
            if i == trace_at:
                prof.stop()
            top = dev.peak()
            peak_abs = max(peak_abs, top)
            solves.append({"seconds": t_last - t0,
                           "iterations": int(sol.result.iterations),
                           "converged": bool(sol.converged),
                           "peak_bytes": top - base})
            # Reservoir sampling: n_keep solves, uniform over the window,
            # chosen by the seed.
            entry = (i, params, sol.w_star, solves[-1]["iterations"])
            if i < n_keep:
                kept.append(entry)
            else:
                j = int(rng.integers(0, i + 1))
                if j < n_keep:
                    kept[j] = entry
            del sol
        window_s = t_last - t_first
    finally:
        spans.uninstall()
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()
    failed = sum(not s["converged"] for s in solves)
    result = {"correct": False, "attempted": len(solves), "failed": failed,
              "metrics": {}, "device": dev.describe(cell.chips)}
    result["device"]["memory_peak_bytes"] = peak_abs
    log(f"wcbench: {cell.name} seed {seed}: {len(solves)} solves in "
        f"{window_s:.4f} s, iterations "
        f"{[s['iterations'] for s in solves]}, seconds "
        f"{[round(s['seconds'], 3) for s in solves]}, setup "
        f"{setup_s:.4f} s")
    if 0 <= trace_at < len(solves):
        # The profiler stretches the solve it traces (host overhead per
        # op): the idle share is of the traced solve's wall.
        rest = sorted(s["seconds"] for k, s in enumerate(solves)
                      if k != trace_at)
        log(f"wcbench: traced solve {solves[trace_at]['seconds']!r} s, "
            f"{solves[trace_at]['iterations']} iterations; untraced "
            f"median {rest[len(rest) // 2] if rest else math.nan!r} s")
    if trace:
        _per_layer(result, readers, cell, solves, spans, prof, trace_at,
                   log)
    else:
        values = {"solve_s": window_s / len(solves),
                  "peak_mem_gib": max(s["peak_bytes"] for s in solves) / GIB,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {
                "value": values[m["name"].split(".")[0]], "unit": m["unit"]}
    t0 = time.perf_counter()
    readings = []
    for i, params, w, its in sorted(kept, key=lambda k: k[0]):
        readings.append(check.numbers(config, traffic, params,
                                      torch.log(w.double()), its,
                                      device=device))
        log(f"wcbench: check solve {i} (gamma {params['gamma']!r}, psi "
            f"{params['psi']!r}, {its} iterations): "
            + ", ".join(f"{k} {v!r}" for k, v in readings[-1].items()))
    log(f"wcbench: reference {time.perf_counter() - t0:.4f} s for "
        f"{len(kept)} solves")
    checks, result["correct"] = check.judge(readings,
                                            cell.check["limits"])
    result["checks"] = checks
    return result, checks


def _per_layer(result, readers, cell, solves, spans, prof, trace_at,
               log) -> None:
    """Per-layer metrics, busy and window seconds and the breakdown."""
    from .spans import Trace
    trace = None
    if prof is not None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            log(f"wcbench: trace {os.path.getsize(path)} bytes")
            trace = Trace(path)
        finally:
            os.unlink(path)
    traced = {trace_at} if trace is not None else set()
    run = Run(cell, solves, spans, trace, traced, result["device"])
    for m in cell.per_layer:
        value = readers[m["name"]].read(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    window = trace.window(SOLVE_SPAN) if trace is not None else None
    if window is None:
        return
    busy, gaps = trace.busy(*window)
    result["device"]["busy_s"] = busy
    result["device"]["window_s"] = 1e-6 * (window[1] - window[0])
    tid = next(iter(trace.spans[SOLVE_SPAN]))
    result["breakdown"] = {
        "device_ops": [list(kv) for kv in trace.top_device_ops(*window)],
        "idle_gaps": [list(kv) for kv in trace.idle_by_host(gaps, tid)]}
    names = sorted(trace.spans)
    for name in names:
        log(f"wcbench: span {name}: {trace.count(name)} calls, device "
            f"{trace.device_seconds(name)!r} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m wcbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # One process with few threads: host-side thread pools spinning on
    # the card's shared CPU cores make the host-bound loops' times
    # spread.  Set before numpy and torch load.
    for var in THREAD_VARS:
        os.environ.setdefault(var, "1")
    from .catalog import load
    catalog = load()
    cell = catalog.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"wcbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    log = lambda s: print(s, file=sys.stderr, flush=True)
    result, checks = run_cell(catalog, cell, args.seed, args.seconds,
                              bool(args.trace), log=log)
    bad = forbidden_modules()
    if bad:
        log(f"wcbench: forbidden modules loaded: {bad}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
