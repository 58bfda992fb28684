"""High-level driver: model -> grids -> operator -> solver.

PyTorch port of ``drivers.wc_ratio_discrete`` (SSY and GCY) and of
``drivers.wc_ratio_continuous`` (SSY and GCY; quadrature or Monte Carlo
expectations; pre-, post- and log-interpolation).  The iterate defaults
to log space (ell = log w), which keeps w > 0 and every intermediate in
float32 range.  ``kernel="xla"`` runs the eager operators (float64 by
default); ``kernel="tiled"`` runs float32 CUDA kernels (the streamed
kernels for discrete SSY and GCY and for continuous GCY, the
post-interp kernel for continuous SSY with interp "post"/"loglin"), and
the continuous ``algorithm="fused_sa"``/``"fused_anderson"`` the
whole-solve CUDA kernels (their plain PyTorch versions on a CPU
device).  Every ``wc_ratio_*`` call runs on the card unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .config import resolve_device
from .kernels.post_interp_kernel import make_post_interp_kernel_T_ssy
from .kernels.tiled_two_phase import (TPU_ONLY_OPTIONS, make_tiled_T_log_gcy,
                                      make_tiled_T_log_gcy_continuous,
                                      make_tiled_T_log_ssy,
                                      reject_tpu_options)
from .models.gcy import GCY
from .models.ssy import SSY
from .operators.continuous_common import additive_profiles
from .operators.continuous_gcy import T_gcy_continuous_factory
from .operators.continuous_ssy import T_ssy_continuous_factory
from .operators.discrete_gcy import (T_gcy_factory, discretize_gcy,
                                     gcy_loglinear_parts)
from .operators.discrete_ssy import T_ssy_factory, discretize_ssy
from .ops.grids import build_grid_gcy, build_grid_ssy
from .solvers import SolveResult, solve

__all__ = ["WCSolution", "wc_ratio_discrete", "wc_ratio_continuous",
           "f32_tol_floor"]

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


def _default_algorithm(model, kernel: str) -> str:
    """Per-path solver default, as the JAX package's: SA for the
    continuous-GCY pair tier (``kernel="tiled"`` with a GCY model), whose
    Newton tangent through the pair twin under-resolves at bounded inner
    iterations; Newton everywhere else (the SSY post-interp kernel
    included)."""
    return ("sa" if (kernel == "tiled" and not isinstance(model, SSY))
            else "newton")


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
                      device="cuda",
                      **solver_opts) -> WCSolution:
    """Solve the discretized SSY or GCY model on ``device`` (the card
    unless the caller asks for the CPU).

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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet; it lands with "
                               f"ROADMAP queue A {item}")


def _check_kernel_path(model, kernel, method, interp, space, baseline):
    """Reject a kernel/method/interp combination before any solve work
    (the coarse baseline is a whole float64 solve)."""
    if kernel not in ("tiled", "xla"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel != "tiled":
        return
    if method != "quadrature" or space != "log":
        raise ValueError("tiled kernels implement the quadrature operators "
                         "in log space")
    if isinstance(model, GCY) and interp != "pre":
        raise ValueError(
            "the continuous-GCY pair kernel covers interp='pre' (factored "
            "quadrature); use kernel='xla' for the post/loglin node-chain "
            "engines")
    if interp in ("post", "loglin") and baseline is not None:
        raise ValueError("the post-interp kernel has no baseline fold; use "
                         "interp='pre' for normalized operators")
    if interp not in ("pre", "post", "loglin"):
        raise ValueError(f"unknown interp {interp!r}")
    if isinstance(model, SSY) and interp == "pre":
        raise _not_ported("kernel='tiled' for the continuous SSY operator "
                          "with interp='pre'",
                          "items 6 (its operand set) and B2 (batched c2)")


def _w0(T, w_init, shape, dtype, dev):
    """The solve's start: ``w_init``, else the folded baseline's w, else
    ones."""
    if w_init is not None:
        return torch.as_tensor(w_init).to(device=dev, dtype=dtype)
    if hasattr(T, "baseline_log_w"):
        return torch.exp(T.baseline_log_w)
    return torch.ones(shape, dtype=dtype, device=dev)


def wc_ratio_continuous(model,
                        grid_sizes: Sequence[int],
                        *,
                        num_std_devs: float = 3.2,
                        method: str = "quadrature",
                        interp: str = "pre",
                        quad_degree: int = 5,
                        mc_draw_size: int = 2000,
                        seed: int = 1234,
                        algorithm: Optional[str] = None,
                        tol: float = 1e-7,
                        space: Optional[str] = None,
                        w_init=None,
                        batch_size: Optional[int] = None,
                        baseline=None,
                        dtype: Optional[torch.dtype] = None,
                        kernel: str = "xla",
                        engine: str = "auto",
                        polish=False,
                        checkpoint_path: Optional[str] = None,
                        device="cuda",
                        **solver_opts) -> WCSolution:
    """Solve the continuous-state SSY or GCY model on interpolation
    grids, on ``device`` (the card unless the caller asks for the CPU).

    Grid bounds via ``num_std_devs`` stationary standard deviations,
    Gauss-Hermite degree ``quad_degree`` per dimension
    (``method="quadrature"``) or ``mc_draw_size`` joint Monte Carlo draws
    of a generator seeded with ``seed`` (``method="monte_carlo"``),
    initial guess all-ones unless ``w_init`` is given (or the folded
    baseline's w).

    ``interp`` is the interpolation space: "pre" interpolates w^theta
    (the factored operator), "post" interpolates w and then takes the
    power (the reference's semantics), "loglin" interpolates log w.

    ``kernel="xla"`` with ``algorithm`` "newton", "sa" or "anderson"
    iterates the eager operator
    (:func:`..operators.continuous_ssy.T_ssy_continuous_factory`,
    :func:`..operators.continuous_gcy.T_gcy_continuous_factory`) in
    ``dtype`` (float64 when None): the factored chain for quadrature +
    "pre", the node chain for "post"/"loglin" in log space, the pointwise
    gather (``engine="gather"``, over batches of ``batch_size`` states)
    otherwise.  ``kernel="tiled"`` iterates float32 CUDA kernels: for SSY
    with interp "post"/"loglin" the post-interp kernel
    (:func:`..kernels.post_interp_kernel.make_post_interp_kernel_T_ssy`,
    no baseline fold), for GCY with "pre" the streamed-pair operator
    (:func:`..kernels.tiled_two_phase.make_tiled_T_log_gcy_continuous`).
    ``algorithm=None`` resolves to "sa" for GCY with ``kernel="tiled"``
    and to "newton" elsewhere.  ``algorithm="fused_sa"`` /
    ``"fused_anderson"`` runs the whole solve as one launch of the
    float32 CUDA kernel (successive approximation / Anderson acceleration
    over the fused two-matmul operator, at most ``max_iter`` = 20,000
    iterations; extra keyword arguments go to the ``make_fused_*``
    factory), on grids built in float32.  As in the JAX package, the
    fused SSY path takes no baseline (``baseline`` is ignored there), and
    the fused GCY path folds "loglinear" unless a baseline is given.

    ``baseline`` folds a separable baseline into the log-space "pre"
    operator: "loglinear" (the closed form), a ``(const, profiles)``
    pair, or "coarse" — solve the model at ``min(size, 5)`` points per
    axis by float64 Newton on ``device``, fit its additive (ANOVA
    main-effects) profiles and interpolate them onto the grids: the
    float32 recipe for GCY, whose log-linear closed form is ~4 log units
    off at the grid corners.  The solve starts from the baseline's w
    when ``w_init`` is None.

    ``engine`` reaches both factories (the JAX driver passes it to the
    SSY factory only).  Not ported yet, each raising
    ``NotImplementedError`` with its ROADMAP item: ``kernel="tiled"``
    for SSY with interp="pre" (item 6), ``polish`` (item 6) and
    ``checkpoint_path`` (item 10).
    """
    space = space or "log"
    if not isinstance(model, (SSY, GCY)):
        raise TypeError(f"unsupported model {type(model).__name__}")
    gcy = isinstance(model, GCY)
    for name, value, item in (("polish", polish, "item 6"),
                              ("checkpoint_path", checkpoint_path,
                               "item 10")):
        if value:
            raise _not_ported(f"{name}={value!r}", item)
    _check_kernel_path(model, kernel, method, interp, space, baseline)
    if algorithm is None:
        algorithm = _default_algorithm(model, kernel)
    dev = resolve_device(device)
    gdtype = dtype or torch.float64
    baseline_spec = baseline
    if isinstance(baseline, str) and baseline == "coarse":
        baseline_spec = _coarse_additive_baseline(
            model, grid_sizes, num_std_devs=num_std_devs,
            quad_degree=quad_degree, dtype=gdtype, device=dev)
    if kernel == "tiled":
        tpu_opts = {k: solver_opts.pop(k) for k in TPU_ONLY_OPTIONS
                    if k in solver_opts}
        reject_tpu_options(tpu_opts)
        if gcy:
            grids = build_grid_gcy(model, *grid_sizes,
                                   num_std_devs=num_std_devs)
            T = make_tiled_T_log_gcy_continuous(
                model, grids, degree=quad_degree, baseline=baseline_spec,
                device=dev)
        else:
            grids = build_grid_ssy(model, *grid_sizes,
                                   num_std_devs=num_std_devs)
            T = make_post_interp_kernel_T_ssy(model, grids,
                                              quad_degree=quad_degree,
                                              interp=interp, device=dev)
        shape = tuple(len(g) for g in grids)
        w0 = _w0(T, w_init, shape, torch.float32, dev)
        sol = _run_solver(T, w0, space, algorithm, tol, solver_opts,
                          theta=model.theta)
        return dataclasses.replace(
            sol, grids=tuple(g.to(torch.float32) for g in grids))
    if algorithm in ("fused_anderson", "fused_sa"):
        return _wc_ratio_continuous_fused(
            model, grid_sizes, algorithm=algorithm, tol=tol,
            num_std_devs=num_std_devs, method=method, interp=interp,
            quad_degree=quad_degree, w_init=w_init, device=dev,
            baseline_spec=baseline_spec, **solver_opts)
    make_grids, factory = ((build_grid_gcy, T_gcy_continuous_factory) if gcy
                           else (build_grid_ssy, T_ssy_continuous_factory))
    grids = make_grids(model, *grid_sizes, num_std_devs=num_std_devs,
                       dtype=gdtype)
    T = factory(model, grids, method=method, interp=interp, space=space,
                quad_degree=quad_degree, mc_draw_size=mc_draw_size,
                seed=seed, batch_size=batch_size, baseline=baseline_spec,
                dtype=dtype, engine=engine, device=dev)
    shape = tuple(len(g) for g in grids)
    w0 = _w0(T, w_init, shape, gdtype, dev)
    sol = _run_solver(T, w0, space, algorithm, tol, solver_opts,
                      theta=model.theta)
    return dataclasses.replace(sol, grids=tuple(grids))


def _coarse_additive_baseline(model, grid_sizes, *, num_std_devs,
                              quad_degree, dtype, device,
                              coarse_size: int = 5,
                              coarse_tol: float = 1e-9):
    """Solve a small float64 model on ``device`` and fit an additive
    baseline on the target grids: ``(const, profiles)``, the profiles
    interpolated axis by axis (numpy float64)."""
    make_grids = build_grid_gcy if isinstance(model, GCY) else build_grid_ssy
    coarse_sizes = tuple(min(int(s), coarse_size) for s in grid_sizes)
    sol = wc_ratio_continuous(model, coarse_sizes, algorithm="newton",
                              tol=coarse_tol, interp="pre", space="log",
                              quad_degree=quad_degree,
                              num_std_devs=num_std_devs, device=device)
    const, profiles = additive_profiles(torch.log(sol.w_star))
    fine_grids = make_grids(model, *grid_sizes, num_std_devs=num_std_devs,
                            dtype=dtype)
    profs = [np.interp(fg.double().numpy(), cg.double().cpu().numpy(), p)
             for fg, cg, p in zip(fine_grids, sol.grids, profiles)]
    return const, profs


def _wc_ratio_continuous_fused(model, grid_sizes, *, algorithm, tol,
                               num_std_devs, method, interp, quad_degree,
                               w_init, device, baseline_spec=None,
                               max_iter: int = 20_000,
                               **solver_opts) -> WCSolution:
    """Whole-solve kernel path (float32, quadrature + pre-interp).

    algorithm="fused_anderson" runs the Anderson kernel, "fused_sa" the
    successive-approximation kernel: the entire solve is one launch.  GCY
    operands are baseline-normalized by construction ("loglinear" unless
    ``baseline_spec`` is given): theta * log-w range ~ 200 on these grids
    overflows raw float32.
    """
    from .kernels import anderson_kernel as ak
    from .kernels import solver_kernel as sk

    if tol < 2e-6:
        warnings.warn(
            f"tol={tol:g} is below the fused kernels' float32 iteration "
            "floor (~1e-5..2e-6 on the log iterate, depending on grid "
            "size); the solve will stop at max_iter with the floor "
            "residual. Use the float64 Newton path for tighter "
            "tolerances.", stacklevel=3)
    if method != "quadrature" or interp != "pre":
        raise ValueError(
            "fused kernels implement the quadrature + pre-interp operator")
    anderson = algorithm == "fused_anderson"
    if isinstance(model, GCY):
        grids = build_grid_gcy(model, *grid_sizes, num_std_devs=num_std_devs,
                               dtype=torch.float32)
        make = (ak.make_fused_anderson_gcy_continuous if anderson
                else sk.make_fused_solver_gcy_continuous)
        fsolve = make(model, grids, degree=quad_degree,
                      baseline=("loglinear" if baseline_spec is None
                                else baseline_spec),
                      device=device, **solver_opts)
    else:
        grids = build_grid_ssy(model, *grid_sizes, num_std_devs=num_std_devs,
                               dtype=torch.float32)
        make = (ak.make_fused_anderson_ssy_continuous if anderson
                else sk.make_fused_solver_ssy_continuous)
        fsolve = make(model, grids, degree=quad_degree, device=device,
                      **solver_opts)
    shape = tuple(len(g) for g in grids)
    if w_init is not None:
        w0 = torch.as_tensor(w_init).to(device=device, dtype=torch.float32)
    elif hasattr(fsolve, "baseline_log_w"):
        w0 = torch.exp(fsolve.baseline_log_w)
    else:
        w0 = torch.ones(shape, dtype=torch.float32, device=device)
    ell, iters, err = fsolve(torch.log(w0), tol, max_iter)
    err = float(err)
    result = SolveResult(x=ell, iterations=int(iters), residual=err,
                         converged=bool(err <= float(np.float32(tol))
                                        and not math.isnan(err)))
    return WCSolution(w_star=torch.exp(ell), grids=tuple(grids),
                      result=result, space="log")
