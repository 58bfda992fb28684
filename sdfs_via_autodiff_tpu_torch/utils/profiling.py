"""Profiling and timing utilities.

PyTorch port of ``sdfs_via_autodiff_tpu/utils/profiling.py``: a
``torch.profiler`` trace context (host and, with a card, device
activity, written as a Chrome trace), and a timing wrapper giving
time-to-tolerance, iterations and grid-point updates per second.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["trace", "timed_solve", "TimedSolve", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class TimedSolve:
    result: "object"            # SolveResult
    wall_seconds: float
    compile_seconds: Optional[float]
    points_per_second: float    # grid-point updates / second

    def __str__(self):
        c = (f", compile {self.compile_seconds:.2f}s"
             if self.compile_seconds is not None else "")
        return (f"{self.result} in {self.wall_seconds:.3f}s{c} "
                f"({self.points_per_second:,.0f} point-updates/s)")


def _run(solve_fn, T, x0, solve_kwargs):
    """One solve and its wall seconds, ended by a device synchronize
    where the result lives on the card."""
    t0 = time.perf_counter()
    res = solve_fn(T, x0, **solve_kwargs)
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    return res, time.perf_counter() - t0


def timed_solve(solve_fn: Callable, T: Callable, x0, *,
                warm_up: bool = True, **solve_kwargs) -> TimedSolve:
    """Run ``solve_fn(T, x0, **kwargs)`` with timing.

    ``warm_up=True`` runs the solve twice and reports the second wall
    time, with the first-minus-second as ``compile_seconds`` (the port
    compiles nothing: this is the cold run's one-time start-up, the
    kernels' build and load included); pass False to time one cold run.
    """
    compile_s = None
    if warm_up:
        _, cold = _run(solve_fn, T, x0, solve_kwargs)
    res, wall = _run(solve_fn, T, x0, solve_kwargs)
    if warm_up:
        compile_s = max(0.0, cold - wall)
    n_points = int(np.prod(tuple(x0.shape)))
    iters = max(1, int(res.iterations))
    return TimedSolve(result=res, wall_seconds=wall,
                      compile_seconds=compile_s,
                      points_per_second=n_points * iters / wall)
