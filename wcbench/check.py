"""The comparison that decides ``correct``.

Each sampled solve of the window is judged by the numbers its cell's
file names under ``limits``, each at most its limit:

- ``logw_err``: the largest distance, over the grid, between the log of
  the w* the timed call returned and the plain reference's answer to the
  same question at the same parameter point.  For Newton the question
  is the fixed point: the reference's float64 Newton-Krylov to a step of
  1e-10.  For successive approximation it is the iterate the solve
  returned: T applied, from the traffic's start, as many times as the
  solve says it did; the reference applies its own float64 T that many
  times.  (The stop itself is ill-conditioned: near it a step shrinks by
  0.14% an iteration, so float32 rounding of the step moves the stop by
  some 20 iterations and the iterate by some 4e-4.)
- ``stop_step`` (successive approximation): the reference's own last
  step at the solve's iteration count, sup |T^N(l0) - T^(N-1)(l0)|, in
  units of the tolerance.  A solve that stopped where the stop rule was
  met reads about 1 (rounding moves it by a few %); one that stopped
  early, whatever its ``converged`` flag says, reads more: 0.14% more
  for each iteration it left out.

The reference builds everything itself from the parameters; it reads
the program's w* and iteration count only to judge them.

The control is the same reference in the program's place, one precision
below (``precision="tf32"``): :func:`control_solver` answers as a timed
call does, and is judged by the same :func:`numbers` and :func:`judge`.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from .reference import build_chain, newton, successive_approx
from .reference.chain import theta_of
from .reference.solve import sup

__all__ = ["FIXED_POINT_TOL", "CONTROL_NEWTON_STEPS", "tol_of", "answer",
           "logw_err", "numbers", "judge", "control_solver"]

FIXED_POINT_TOL = 1e-10
# Newton on the TF32 operator never takes a step below the cells'
# tolerances: its residual stalls at the operator's rounding (~6e-5 on
# log w), and its iterate stays within a few 1e-4 of one point from the
# tenth step on.  The control reads that point after this many steps.
CONTROL_NEWTON_STEPS = 16


def tol_of(config: dict, params: dict) -> float:
    """The configuration's tolerance at ``params``: a fixed ``value``, or
    ``f32_floor_factor`` times the float32 floor of the log iterate,
    5e-6 max(1, (|theta| / 16)^2) (the driver's rule for GCY)."""
    rule = config["tol"]
    if "value" in rule:
        return float(rule["value"])
    theta = theta_of(params)
    return rule["f32_floor_factor"] * 5e-6 * max(1.0, (abs(theta) / 16) ** 2)


def _start(config: dict, traffic: dict, params: dict, device,
           precision: str):
    chain = build_chain(config["model"], params, config["shapes"],
                        device=device, precision=precision)
    ell0 = torch.full(chain.shape, math.log(traffic["start_w"]),
                      dtype=chain.dtype, device=device)
    return chain, ell0


def answer(config: dict, traffic: dict, params: dict, *, device,
           precision: str = "float64", iterations: int = None):
    """(the reference's log w* at ``params`` in its precision's dtype,
    iterations).  For "sa" ``iterations`` fixes the count; without it
    the reference runs to its own stop."""
    chain, ell0 = _start(config, traffic, params, device, precision)
    tol = tol_of(config, params)
    if traffic["algorithm"] == "sa":
        if iterations is None:
            ell, n, _ = successive_approx(chain, ell0, tol)
        else:
            ell, n = ell0, int(iterations)
            for _ in range(n):
                ell = chain(ell)
    elif traffic["algorithm"] == "newton":
        if precision == "float64":
            ell, n, _ = newton(chain, ell0, FIXED_POINT_TOL)
        else:
            ell, n, _ = newton(chain, ell0, tol,
                               max_iter=CONTROL_NEWTON_STEPS)
    else:
        raise ValueError(f"no reference for algorithm "
                         f"{traffic['algorithm']!r}")
    return ell, n


def logw_err(log_w: torch.Tensor, ref: torch.Tensor) -> float:
    """max |log w - ref| over the grid, in float64."""
    return float((log_w.double() - ref.double()).abs().max())


def numbers(config: dict, traffic: dict, params: dict,
            log_w: torch.Tensor, iterations: int, *, device) -> dict:
    """The numbers compared for one solve that answered ``log_w`` after
    ``iterations``: ``logw_err`` and, for successive approximation,
    ``stop_step``; with ``early_stop_step``, the step at half the count
    in units of the tolerance (what an SA that stopped at half its
    iterations would read; logged, never compared)."""
    if traffic["algorithm"] != "sa":
        ref, _ = answer(config, traffic, params, device=device)
        return {"logw_err": logw_err(log_w, ref)}
    chain, ell = _start(config, traffic, params, device, "float64")
    tol = tol_of(config, params)
    n = int(iterations)
    out = {"stop_step": math.nan, "early_stop_step": math.nan}
    for k in range(1, n + 1):
        nxt = chain(ell)
        if k == n:
            out["stop_step"] = sup(nxt - ell) / tol
        elif k == n // 2:
            out["early_stop_step"] = sup(nxt - ell) / tol
        ell = nxt
    return {"logw_err": logw_err(log_w, ell), **out}


def judge(readings, limits: dict):
    """(checks, correct) over the readings of a run's sampled solves:
    for each number ``limits`` names, the largest reading beside its
    limit; correct when every reading is finite and within its limit.
    A run with no reading is not correct."""
    checks, ok = {}, bool(readings)
    for name, limit in limits.items():
        vals = [r[name] for r in readings]
        value = max(vals) if vals else math.nan
        checks[name] = {"value": value, "limit": float(limit)}
        ok = ok and all(math.isfinite(v) for v in vals) and \
            value <= float(limit)
    return checks, ok


def control_solver(config: dict, traffic: dict, *, device):
    """A stand-in for the timed call: the reference one precision below
    (TF32 products), answering with w* and its iteration count.  Newton
    stops at the cell's tolerance or after CONTROL_NEWTON_STEPS; an SA
    control never reaches the tolerance (its steps' rounding exceeds
    it), so it runs the float64 reference's own count."""

    def solve(params):
        n = None
        if traffic["algorithm"] == "sa":
            _, n = answer(config, traffic, params, device=device)
        ell, n = answer(config, traffic, params, device=device,
                        precision="tf32", iterations=n)
        return SimpleNamespace(w_star=torch.exp(ell), converged=True,
                               result=SimpleNamespace(iterations=n))
    return solve
