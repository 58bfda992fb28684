"""High-level driver: model -> grids -> operator -> solver.

PyTorch port of ``drivers.wc_ratio_discrete`` for the SSY and GCY models.
The iterate defaults to log space (ell = log w), which keeps w > 0 and every
intermediate in float32 range.  ``kernel="xla"`` runs the eager per-axis
operator (float64 by default); ``kernel="tiled"`` runs the float32
streamed CUDA kernels (their plain PyTorch versions on a CPU device).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import torch

from .config import resolve_device
from .kernels.tiled_two_phase import (TPU_ONLY_OPTIONS, make_tiled_T_log_gcy,
                                      make_tiled_T_log_ssy,
                                      reject_tpu_options)
from .models.gcy import GCY
from .models.ssy import SSY
from .operators.discrete_gcy import (T_gcy_factory, discretize_gcy,
                                     gcy_loglinear_parts)
from .operators.discrete_ssy import T_ssy_factory, discretize_ssy
from .solvers import SolveResult, solve

__all__ = ["WCSolution", "wc_ratio_discrete", "f32_tol_floor"]

DEFAULT_INIT_W = 800.0   # reference w_init


@dataclasses.dataclass
class WCSolution:
    """Wealth-consumption-ratio solve output: w* plus how we got it."""
    w_star: torch.Tensor
    grids: Optional[tuple]
    result: SolveResult
    space: str

    @property
    def converged(self) -> bool:
        return self.result.converged


def f32_tol_floor(theta: Optional[float]) -> float:
    """Practical float32 sup-norm floor of the log iterate, scaled by the
    risk-aversion exponent theta.

    The per-application f32 bias (~3 ulp of the log iterate) amplifies by
    the fixed-point factor 1/(1-rate) into the solution; the attainable
    floor also grows with |theta| because w = 1 + beta (H w^theta)^(1/theta)
    wraps every evaluation in a theta-power round trip (quadratic |theta|
    scaling from the two theta-scaled transcendental round trips).
    """
    if theta is None:
        return 5e-6
    return 5e-6 * max(1.0, (abs(float(theta)) / 16.0) ** 2)


def _run_solver(T, w0, space, algorithm, tol, solver_opts,
                theta: Optional[float] = None) -> WCSolution:
    floor = f32_tol_floor(theta)
    if w0.dtype == torch.float32 and tol < floor:
        warnings.warn(
            f"tol={tol:g} is below the float32 iteration floor "
            f"(~{floor:.0e} on the log iterate for theta={theta}); the "
            "solve may stall (stall guard -> converged=False). Use "
            "float64 or relax tol.", stacklevel=3)
    if space == "log":
        res = solve(T, torch.log(w0), method=algorithm, tol=tol,
                    **solver_opts)
        w_star = torch.exp(res.x)
    else:
        res = solve(T, w0, method=algorithm, tol=tol, **solver_opts)
        w_star = res.x
    return WCSolution(w_star=w_star, grids=None, result=res, space=space)


def wc_ratio_discrete(model,
                      shapes: Sequence[int],
                      *,
                      algorithm: str = "newton",
                      tol: float = 1e-7,
                      space: Optional[str] = None,
                      w_init=None,
                      dtype: Optional[torch.dtype] = None,
                      kernel: str = "xla",
                      baseline: Optional[str] = None,
                      discretization: str = "rouwenhorst",
                      polish=False,
                      checkpoint_path: Optional[str] = None,
                      device,
                      **solver_opts) -> WCSolution:
    """Solve the discretized SSY or GCY model on ``device``.

    ``kernel="xla"``: the eager per-axis operator in ``dtype`` (float64
    when None), log space by default, ``space="w"`` for strict reference
    semantics.  ``kernel="tiled"``: the float32 streamed kernels, log
    space only; for GCY they iterate from the log-linear solution
    (``gcy_loglinear_parts(...)["ell0"]``) when ``w_init`` is None.
    ``discretization`` is "rouwenhorst" or "tauchen" (whose grid spans a
    fixed +-3 unconditional std at any point count, making fine float32
    grids range-safe).  Extra keyword arguments go to the solver; the
    TPU-only options of the JAX tiled tier are rejected.  A model that is
    neither SSY nor GCY raises ``TypeError``.

    Not ported yet, each raising ``NotImplementedError``:
    ``baseline="loglinear"`` (ROADMAP queue A items 2, 4 and 5),
    ``polish`` (item 4) and ``checkpoint_path`` (item 10).
    """
    space = space or "log"
    if kernel not in ("xla", "tiled"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if not isinstance(model, (SSY, GCY)):
        raise TypeError(f"unsupported model {type(model).__name__}")
    for name, value, item in (("baseline", baseline, "items 2, 4 and 5"),
                              ("polish", polish, "item 4"),
                              ("checkpoint_path", checkpoint_path,
                               "item 10")):
        if value:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet; it lands with "
                f"ROADMAP queue A {item}")
    dev = resolve_device(device)
    gcy = isinstance(model, GCY)
    disc = (discretize_gcy if gcy else discretize_ssy)(
        model, tuple(shapes), method=discretization)
    if kernel == "tiled":
        if space != "log":
            raise ValueError("tiled kernels iterate in log space")
        tpu_opts = {k: solver_opts.pop(k) for k in TPU_ONLY_OPTIONS
                    if k in solver_opts}
        reject_tpu_options(tpu_opts)
        if gcy:
            T = make_tiled_T_log_gcy(model, disc, device=dev)
            if w_init is None:
                # Log-linear warm start: beta = 0.9987 makes cold starts
                # crawl.
                w_init = torch.exp(torch.as_tensor(
                    gcy_loglinear_parts(model, disc)["ell0"],
                    dtype=torch.float32))
        else:
            T = make_tiled_T_log_ssy(model, disc, device=dev)
        wdtype = torch.float32
    else:
        factory = T_gcy_factory if gcy else T_ssy_factory
        T = factory(model, disc, space=space, dtype=dtype, device=dev)
        wdtype = dtype or torch.float64
    w0 = (torch.full(tuple(shapes), DEFAULT_INIT_W, dtype=wdtype, device=dev)
          if w_init is None
          else torch.as_tensor(w_init).to(device=dev, dtype=wdtype))
    return _run_solver(T, w0, space, algorithm, tol, solver_opts,
                       theta=model.theta)
