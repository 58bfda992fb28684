"""High-level driver: model -> grids -> operator -> solver.

PyTorch port of ``drivers.wc_ratio_discrete`` (SSY and GCY) and of
``drivers.wc_ratio_continuous`` (SSY and GCY; quadrature or Monte Carlo
expectations; pre-, post- and log-interpolation).  The iterate defaults
to log space (ell = log w), which keeps w > 0 and every intermediate in
float32 range.  ``kernel="xla"`` runs the eager operators (float64 by
default); ``kernel="tiled"`` runs float32 CUDA kernels (the streamed
kernels for discrete SSY and GCY and for continuous SSY with interp
"pre" and continuous GCY, the post-interp kernel for continuous SSY
with interp "post"/"loglin"), and
the continuous ``algorithm="fused_sa"``/``"fused_anderson"`` the
whole-solve CUDA kernels (their plain PyTorch versions on a CPU
device).  ``polish`` refines either driver's solve with a float64
Newton solve; ``checkpoint_path`` writes the solution in the JAX
package's format (:mod:`.utils.checkpoint`); ``wc_ratio_differentiable``
makes w* a differentiable function of model fields (implicit
differentiation); ``wc_ratio_sweep`` solves a batch of calibrations;
``degroot_fixed_point`` solves the de Groot specification.  Every
``wc_ratio_*`` call runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import inspect
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
                                      make_tiled_T_log_ssy_continuous,
                                      reject_tpu_options)
from .models.gcy import GCY
from .models.ssy import SSY
from .operators.continuous_common import additive_profiles
from .operators.continuous_gcy import T_gcy_continuous_factory
from .operators.continuous_ssy import T_ssy_continuous_factory
from .operators.discrete_gcy import (T_gcy_factory, discretize_gcy,
                                     gcy_loglinear_start)
from .operators.discrete_ssy import T_ssy_factory, discretize_ssy
from .ops.grids import build_grid_gcy, build_grid_ssy, flatten_mesh
from .ops.interp import lin_interp
from .solvers import SolveResult, newton_solver, solve
from .utils.checkpoint import save_solution
from .utils.profiling import span, spanned

__all__ = ["WCSolution", "wc_ratio_discrete", "wc_ratio_continuous",
           "wc_ratio_continuation", "wc_ratio_sweep",
           "wc_ratio_differentiable", "prolong_w", "f32_tol_floor",
           "DeGrootSolution", "degroot_fixed_point"]

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


def _polish_stage(polish) -> str:
    """Normalize the ``polish`` argument to a stage placement: ``True``
    and ``"device"`` refine in float64 on the caller's device (the card:
    IEEE float64 there); ``"host"`` refines on the CPU."""
    if polish is True or polish == "device":
        return "device"
    if polish == "host":
        return "host"
    raise ValueError(f"polish must be True, 'host', or 'device', "
                     f"got {polish!r}")


def _newton_applicable(solver_opts: dict) -> dict:
    """The caller's solver options that the Newton solver accepts: the
    polish stage always refines with Newton, whatever the fast stage
    ran."""
    allowed = set(inspect.signature(newton_solver).parameters) - {"T", "x0"}
    return {k: v for k, v in solver_opts.items() if k in allowed}


def _polish_opts(polish, kernel, T_fast, solver_opts, dev):
    """(device, Newton options) of the float64 polish stage.

    On the caller's device a ``kernel="tiled"`` fast stage lends its
    float32 operator as ``tangent_T`` (mixed-precision iterative
    refinement); it lives there, so the host stage linearizes ``T``.
    """
    stage = _polish_stage(polish)
    popts = _newton_applicable(solver_opts)
    pdev = dev if stage == "device" else torch.device("cpu")
    if stage == "device" and kernel == "tiled" and "tangent_T" not in popts:
        popts["tangent_T"] = T_fast
    return pdev, popts


def _save(checkpoint_path, model, grids, sol, kernel, **meta) -> None:
    """Write ``sol`` to ``checkpoint_path`` (when given) with the JAX
    drivers' meta: the caller's settings, ``kernel="tiled"`` on the
    tiled tier, then iterations and residual."""
    if checkpoint_path:
        if kernel == "tiled":
            meta["kernel"] = "tiled"
        save_solution(checkpoint_path, model, grids, sol.w_star,
                      meta=dict(meta,
                                iterations=int(sol.result.iterations),
                                residual=float(sol.result.residual)))


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
    grids range-safe).  ``baseline="loglinear"`` runs the normalized
    operators: the per-axis chain with the log-linear solution folded in
    (``kernel="xla"``), or the normalized operand sets on the tiled tier
    (streamed kernels through the conjugated-shared form where they
    cover it, else the strip kernels); the tiled GCY start is then the
    operator's own ``T.baseline_log_w``.  Extra keyword arguments go to
    the solver; the TPU-only options of the JAX tiled tier are rejected.
    A model that is neither SSY nor GCY raises ``TypeError``.

    ``polish`` (``True``, ``"device"`` or ``"host"``): solve first as
    asked at ``tol=max(tol, 1e-4)`` (the fast stage), then refine with a
    float64 Newton solve of the plain eager operator in log space (the
    baseline dropped: float64 needs no range fold) from the fast stage's
    w*, with the caller's Newton-applicable solver options.  ``True``
    and ``"device"`` run that stage on ``device`` — with
    ``kernel="tiled"`` its Krylov matvecs linearize the fast stage's
    float32 operator (``newton_solver(tangent_T=)``) — and ``"host"``
    runs it on the CPU.  (In the JAX package ``True`` means the host.)

    ``checkpoint_path`` writes the solution
    (:func:`..utils.checkpoint.save_solution`, no grids) with the JAX
    driver's meta: kind, shapes, algorithm, tol, space (and
    ``kernel="tiled"`` on the tiled tier), iterations and residual; with
    ``polish`` the float64 stage writes it.

    The call is a ``sdfs.solve`` span, the root of the spans it records
    (``utils/profiling.py``); the operator's build is ``sdfs.build``.
    """
    with span("sdfs.solve"):
        space = space or "log"
        if kernel not in ("xla", "tiled"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if not isinstance(model, (SSY, GCY)):
            raise TypeError(f"unsupported model {type(model).__name__}")
        if baseline not in (None, "loglinear"):
            raise ValueError(f"unknown baseline {baseline!r}")
        if polish:
            _polish_stage(polish)
        dev = resolve_device(device)
        sol, T = _solve_discrete(
            model, shapes, algorithm=algorithm,
            tol=max(tol, 1e-4) if polish else tol, space=space, w_init=w_init,
            dtype=dtype, kernel=kernel, baseline=baseline,
            discretization=discretization, dev=dev, solver_opts=solver_opts)
        if not polish:
            _save(checkpoint_path, model, (), sol, kernel, kind="discrete",
                  shapes=list(shapes), algorithm=algorithm, tol=tol,
                  space=space)
            return sol
        pdev, popts = _polish_opts(polish, kernel, T, solver_opts, dev)
        del T
        return wc_ratio_discrete(
            model, shapes, algorithm="newton", tol=tol, space="log",
            discretization=discretization, device=pdev,
            w_init=sol.w_star.to(device=pdev, dtype=torch.float64),
            checkpoint_path=checkpoint_path, **popts)


def _solve_discrete(model, shapes, *, algorithm, tol, space, w_init, dtype,
                    kernel, baseline, discretization, dev, solver_opts):
    """The discrete solve: (WCSolution, the operator it iterated)."""
    solver_opts = dict(solver_opts)
    T, w0 = _build_discrete(model, shapes, space=space, w_init=w_init,
                            dtype=dtype, kernel=kernel, baseline=baseline,
                            discretization=discretization, dev=dev,
                            solver_opts=solver_opts)
    return _run_solver(T, w0, space, algorithm, tol, solver_opts,
                       theta=model.theta), T


@spanned("sdfs.build")
def _build_discrete(model, shapes, *, space, w_init, dtype, kernel,
                    baseline, discretization, dev, solver_opts):
    """(operator, start w on ``dev``) of a discrete solve; takes the JAX
    tiled tier's options out of ``solver_opts``."""
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
            T = make_tiled_T_log_gcy(model, disc, baseline=baseline,
                                     device=dev)
            if w_init is None:
                # Log-linear warm start: beta = 0.9987 makes cold starts
                # crawl.  The normalized operator already holds it.
                ell0 = getattr(T, "baseline_log_w", None)
                if ell0 is None:
                    ell0 = gcy_loglinear_start(model, disc, device=dev)
                w_init = torch.exp(ell0)
        else:
            T = make_tiled_T_log_ssy(model, disc, baseline=baseline,
                                     device=dev)
        wdtype = torch.float32
    else:
        factory = T_gcy_factory if gcy else T_ssy_factory
        T = factory(model, disc, space=space, dtype=dtype,
                    baseline=baseline, device=dev)
        wdtype = dtype or torch.float64
    w0 = (torch.full(tuple(shapes), DEFAULT_INIT_W, dtype=wdtype, device=dev)
          if w_init is None
          else torch.as_tensor(w_init).to(device=dev, dtype=wdtype))
    return T, w0


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
    with interp "pre" the streamed operator in its batched configuration
    (:func:`..kernels.tiled_two_phase.make_tiled_T_log_ssy_continuous`,
    fast mode, or lse with a baseline), with "post"/"loglin" the
    post-interp kernel
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
    SSY factory only).

    ``polish`` (``True``, ``"device"`` or ``"host"``): solve first as
    asked at ``tol=max(tol, 1e-4)`` (the fast stage), then refine with a
    float64 Newton solve of the same configuration through the eager
    operator (``kernel="xla"``, log space, the baseline dropped) from
    the fast stage's w*, with the caller's Newton-applicable solver
    options.  ``True`` and ``"device"`` run that stage on ``device`` —
    with ``kernel="tiled"`` its Krylov matvecs linearize the fast
    stage's float32 operator (``newton_solver(tangent_T=)``) — and
    ``"host"`` runs it on the CPU.  (In the JAX package ``True`` means
    the host.)

    ``checkpoint_path`` writes the solution with its grids
    (:func:`..utils.checkpoint.save_solution`) and the JAX driver's
    meta: kind, method, interp, quad_degree, num_std_devs, algorithm,
    tol, space (and ``kernel="tiled"`` on the tiled tier), iterations
    and residual; with ``polish`` the float64 stage writes it.
    """
    space = space or "log"
    if not isinstance(model, (SSY, GCY)):
        raise TypeError(f"unsupported model {type(model).__name__}")
    if polish:
        _polish_stage(polish)
    _check_kernel_path(model, kernel, method, interp, space, baseline)
    if algorithm is None:
        algorithm = _default_algorithm(model, kernel)
    dev = resolve_device(device)
    common = dict(num_std_devs=num_std_devs, method=method, interp=interp,
                  quad_degree=quad_degree, mc_draw_size=mc_draw_size,
                  seed=seed, batch_size=batch_size, engine=engine)
    sol, T = _solve_continuous(
        model, grid_sizes, algorithm=algorithm,
        tol=max(tol, 1e-4) if polish else tol, space=space, w_init=w_init,
        baseline=baseline, dtype=dtype, kernel=kernel, dev=dev,
        solver_opts=solver_opts, **common)
    if not polish:
        fused = algorithm in ("fused_anderson", "fused_sa")
        _save(checkpoint_path, model, sol.grids, sol, kernel,
              kind="continuous", method=method, interp=interp,
              quad_degree=quad_degree, num_std_devs=num_std_devs,
              algorithm=algorithm, tol=tol,
              space="log" if fused else space)
        return sol
    pdev, popts = _polish_opts(polish, kernel, T, solver_opts, dev)
    del T
    return wc_ratio_continuous(
        model, grid_sizes, algorithm="newton", tol=tol, space="log",
        device=pdev, w_init=sol.w_star.to(device=pdev, dtype=torch.float64),
        checkpoint_path=checkpoint_path, **common, **popts)


def _solve_continuous(model, grid_sizes, *, num_std_devs, method, interp,
                      quad_degree, mc_draw_size, seed, algorithm, tol,
                      space, w_init, batch_size, baseline, dtype, kernel,
                      engine, dev, solver_opts):
    """The continuous solve: (WCSolution, the operator it iterated; None
    for the fused whole-solve kernels)."""
    solver_opts = dict(solver_opts)
    gcy = isinstance(model, GCY)
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
            if interp == "pre":
                T = make_tiled_T_log_ssy_continuous(
                    model, grids, degree=quad_degree, baseline=baseline_spec,
                    device=dev)
            else:
                T = make_post_interp_kernel_T_ssy(model, grids,
                                                  quad_degree=quad_degree,
                                                  interp=interp, device=dev)
        shape = tuple(len(g) for g in grids)
        w0 = _w0(T, w_init, shape, torch.float32, dev)
        sol = _run_solver(T, w0, space, algorithm, tol, solver_opts,
                          theta=model.theta)
        return dataclasses.replace(
            sol, grids=tuple(g.to(torch.float32) for g in grids)), T
    if algorithm in ("fused_anderson", "fused_sa"):
        return _wc_ratio_continuous_fused(
            model, grid_sizes, algorithm=algorithm, tol=tol,
            num_std_devs=num_std_devs, method=method, interp=interp,
            quad_degree=quad_degree, w_init=w_init, device=dev,
            baseline_spec=baseline_spec, **solver_opts), None
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
    return dataclasses.replace(sol, grids=tuple(grids)), T


# Fields that enter the discrete operator only through the factor
# construction (theta, kappa): differentiable with the discretization
# held fixed.  Dynamics fields shape the chains themselves and need the
# continuous kind, whose operator construction stays in the graph.
_PREFERENCE_FIELDS = frozenset({"beta", "gamma", "psi", "mu_c"})


def wc_ratio_differentiable(model,
                            grid_sizes: Sequence[int],
                            *,
                            fields: Sequence[str] = ("beta", "gamma", "psi"),
                            kind: str = "continuous",
                            quad_degree: int = 5,
                            space: str = "log",
                            num_std_devs: float = 3.2,
                            dtype: Optional[torch.dtype] = None,
                            algorithm: str = "newton",
                            tol: float = 1e-7,
                            w_init=None,
                            adjoint_rtol: float = 1e-8,
                            adjoint_maxiter: int = 200,
                            device="cuda",
                            **solver_opts):
    """A differentiable calibration map ``p -> w*(p)``.

    Returns ``(wc_fn, p0)``: ``p0`` is a dict of the base model's values
    of ``fields`` as 0-d float64 tensors on the CPU (the parameters enter
    the operator's host-side construction, whose arrays then move to
    ``device``), and ``wc_fn(p)`` solves the model with those values on
    ``device`` and returns the W/C ratio field, differentiable in ``p``
    through the implicit function theorem
    (:func:`..solvers.implicit.implicit_fixed_point`): a gradient costs
    one fixed-point solve plus one adjoint Krylov solve.

    ``kind="continuous"`` differentiates the factored quadrature
    ``interp="pre"`` chain (any model field) with grids and quadrature
    nodes fixed at the base calibration (``wc_fn.grids``, on
    ``device``); no baseline fold, float64 by default.
    ``kind="discrete"`` differentiates the per-axis discrete operator with
    the Rouwenhorst discretization held fixed, which is exact for the
    preference fields (beta, gamma, psi, mu_c) only; other fields raise.
    """
    from .solvers.implicit import implicit_fixed_point

    fam = type(model)
    gcy = isinstance(model, GCY)
    valid = {f.name for f in dataclasses.fields(fam)}
    bad = [f for f in fields if f not in valid]
    if bad:
        raise ValueError(f"unknown model fields {bad}; valid: {sorted(valid)}")
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    if kind not in ("continuous", "discrete"):
        raise ValueError(f"unknown kind {kind!r}")
    if len(grid_sizes) != (6 if gcy else 4):
        raise ValueError(f"grid_sizes must have {6 if gcy else 4} "
                         "entries for this family")
    if kind == "discrete":
        non_pref = [f for f in fields if f not in _PREFERENCE_FIELDS]
        if non_pref:
            raise ValueError(
                f"kind='discrete' holds the Rouwenhorst discretization "
                f"fixed, so only preference fields "
                f"{sorted(_PREFERENCE_FIELDS & valid)} differentiate "
                f"exactly; {non_pref} shape the chains themselves — use "
                f"kind='continuous' for dynamics-field gradients")
    dev = resolve_device(device)
    gdtype = dtype or torch.float64
    fields = tuple(fields)
    shape = tuple(int(s) for s in grid_sizes)
    w0 = (torch.full(shape, DEFAULT_INIT_W, dtype=gdtype, device=dev)
          if w_init is None
          else torch.as_tensor(w_init).to(device=dev,
                                          dtype=gdtype).reshape(shape))
    x0 = torch.log(w0) if space == "log" else w0

    grids = None
    if kind == "discrete":
        disc = (discretize_gcy if gcy else discretize_ssy)(model, shape)
        factory = T_gcy_factory if gcy else T_ssy_factory

        def build(m):
            return factory(m, disc, space=space, dtype=gdtype, device=dev)
    else:
        if gcy:
            from .operators.continuous_gcy import _factored_T
        else:
            from .operators.continuous_ssy import _factored_T
        grids = (build_grid_gcy if gcy else build_grid_ssy)(
            model, *grid_sizes, num_std_devs=num_std_devs, dtype=gdtype)

        def build(m):
            return _factored_T(m, grids, quad_degree, space, gdtype, None,
                               device=dev)

    # The operator is built once per parameter point: the solver applies
    # T_of_p(p, .) many times with the same tensors.
    last = {"p": None, "T": None}

    def T_of_p(p, x):
        leaves = tuple(p[k] for k in fields)
        if last["p"] is None or any(a is not b for a, b in
                                    zip(last["p"], leaves)):
            m = dataclasses.replace(model, **dict(zip(fields, leaves)))
            last["p"], last["T"] = leaves, build(m)
        return last["T"](x)

    def wc_fn(p):
        x_star = implicit_fixed_point(
            T_of_p, {k: p[k] for k in fields}, x0, method=algorithm,
            tol=tol, adjoint_rtol=adjoint_rtol,
            adjoint_maxiter=adjoint_maxiter, **solver_opts)
        return torch.exp(x_star) if space == "log" else x_star

    # The grids the returned field is collocated on (continuous kind):
    # moment pipelines interpolate on these.  None for the discrete kind.
    wc_fn.grids = (None if grids is None
                   else tuple(g.to(dev) for g in grids))
    p0 = {f: torch.tensor(float(getattr(model, f)), dtype=torch.float64)
          for f in fields}
    return wc_fn, p0


def prolong_w(w_coarse, grids_coarse, grids_fine) -> torch.Tensor:
    """Prolongate a solved w field from coarse grids to finer grids by
    multilinear interpolation of log w (which keeps w positive), on the
    fine grids' device and in their dtype.

    The workhorse of grid continuation: beta ~ 1 makes cold starts pay
    thousands of contraction-rate iterations to move the level; a coarse
    solve captures the level for the cost of a tiny grid, and the fine
    solve then runs a few Newton steps on the shape.
    """
    grids_fine = tuple(torch.as_tensor(g) for g in grids_fine)
    dev, dtype = grids_fine[0].device, grids_fine[0].dtype
    grids_coarse = tuple(torch.as_tensor(g).to(device=dev, dtype=dtype)
                         for g in grids_coarse)
    ell_c = torch.log(torch.as_tensor(w_coarse).to(device=dev, dtype=dtype))
    ell_f = lin_interp(flatten_mesh(grids_fine).T, ell_c, grids_coarse)
    return torch.exp(ell_f).reshape(tuple(len(g) for g in grids_fine))


def wc_ratio_continuation(model,
                          grid_schedule: Sequence[Sequence[int]],
                          *,
                          algorithm: str = "newton",
                          tol: float = 1e-7,
                          coarse_tol: Optional[float] = None,
                          device="cuda",
                          **kwargs) -> WCSolution:
    """Continuation solve over a schedule of grid sizes.

    Solves the continuous model on ``grid_schedule[0]`` with
    :func:`wc_ratio_continuous`, prolongates each solution
    (:func:`prolong_w`) as the next level's start, and returns the finest
    level's :class:`WCSolution`.  ``coarse_tol`` (default min(1e-4,
    100 tol)) applies to every level but the last; other keyword
    arguments go to every level.
    """
    if not grid_schedule:
        raise ValueError("empty grid schedule")
    coarse_tol = coarse_tol if coarse_tol is not None else min(1e-4,
                                                               tol * 100)
    dev = resolve_device(device)
    builder = build_grid_ssy if isinstance(model, SSY) else build_grid_gcy
    sol = None
    for level, sizes in enumerate(grid_schedule):
        last = level == len(grid_schedule) - 1
        w_init = None
        if sol is not None:
            grids_fine = builder(model, *sizes,
                                 num_std_devs=kwargs.get("num_std_devs", 3.2),
                                 dtype=kwargs.get("dtype") or torch.float64)
            w_init = prolong_w(sol.w_star, sol.grids,
                               tuple(g.to(dev) for g in grids_fine))
        sol = wc_ratio_continuous(
            model, sizes, algorithm=algorithm,
            tol=tol if last else coarse_tol, w_init=w_init, device=dev,
            **kwargs)
    return sol


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


def wc_ratio_sweep(models: Sequence,
                   grid_sizes: Sequence[int],
                   *,
                   num_std_devs: float = 3.2,
                   quad_degree: int = 5,
                   algorithm: str = "newton",
                   tol: float = 1e-7,
                   space: str = "log",
                   w_init=None,
                   dtype: Optional[torch.dtype] = None,
                   device="cuda",
                   **solver_opts):
    """Solve many calibrations of one model family: each member's
    factored quadrature ``interp="pre"`` operator on its own grids, in
    ``dtype`` (float64 when None) on ``device``.

    The JAX package vmaps build-and-solve under one ``jit`` so that one
    compile covers the sweep; the port compiles nothing and solves the
    members one after the other (a vmapped while loop stops each member
    on its own condition too, so the results are the same).  No
    ``baseline`` fold.  ``w_init`` is None (w = 800), a field of the grid
    shape shared by every member, or one per member, (S,) + shape.

    Returns ``(w_star, result, grids_stacked)``: w* stacked (S,) + shape,
    a :class:`SolveResult` whose fields have a leading sweep axis
    (``x`` stacked on ``device``; ``iterations``, ``residual`` and
    ``converged`` as CPU tensors), and each grid axis stacked (S, n).
    """
    models = list(models)
    if not models:
        raise ValueError("empty sweep")
    fam = type(models[0])
    if any(type(m) is not fam for m in models):
        raise ValueError("one sweep = one model family; got mixed types")
    if space not in ("w", "log"):
        raise ValueError(f"unknown space {space!r}")
    gcy = isinstance(models[0], GCY)
    if gcy:
        from .operators.continuous_gcy import _factored_T
    else:
        from .operators.continuous_ssy import _factored_T
    if len(grid_sizes) != (6 if gcy else 4):
        raise ValueError(f"grid_sizes must have {6 if gcy else 4} "
                         "entries for this family")
    dev = resolve_device(device)
    gdtype = dtype or torch.float64
    S = len(models)
    shape = tuple(int(s) for s in grid_sizes)
    if w_init is None:
        w0 = torch.full((S,) + shape, DEFAULT_INIT_W, dtype=gdtype,
                        device=dev)
    else:
        w0 = torch.as_tensor(w_init).to(device=dev, dtype=gdtype)
        if tuple(w0.shape) == shape:
            w0 = w0.expand((S,) + shape)
        elif tuple(w0.shape) != (S,) + shape:
            raise ValueError(f"w_init shape {tuple(w0.shape)} matches "
                             f"neither {shape} nor {(S,) + shape}")
    x0 = torch.log(w0) if space == "log" else w0
    make_grids = build_grid_gcy if gcy else build_grid_ssy
    grids_list = [make_grids(m, *grid_sizes, num_std_devs=num_std_devs,
                             dtype=gdtype) for m in models]
    results = [solve(_factored_T(m, grids, quad_degree, space, gdtype,
                                 None, device=dev),
                     x0[i], method=algorithm, tol=tol, **solver_opts)
               for i, (m, grids) in enumerate(zip(models, grids_list))]
    res = SolveResult(
        x=torch.stack([r.x for r in results]),
        iterations=torch.tensor([r.iterations for r in results]),
        residual=torch.tensor([r.residual for r in results],
                              dtype=torch.float64),
        converged=torch.tensor([r.converged for r in results]))
    w_star = torch.exp(res.x) if space == "log" else res.x
    grids_stacked = tuple(torch.stack([g[d] for g in grids_list]).to(dev)
                          for d in range(len(grid_sizes)))
    return w_star, res, grids_stacked


# ---------------------------------------------------------------------------
# de Groot alternative specification

@dataclasses.dataclass
class DeGrootSolution:
    """Fixed point g* = (V/C)^(1-gamma) of the de Groot aggregator.

    ``log_g_star`` is the canonical storage: theta enters T~ as an
    *outer* power, so g* scales like (O(1))^theta (at the GCY
    calibration with h = 1 it lives at e^97..e^124).  ``g_star``
    materializes exp(log g*) on demand.
    """
    log_g_star: torch.Tensor
    grids: Optional[tuple]
    result: SolveResult
    space: str

    @property
    def converged(self) -> bool:
        return self.result.converged

    @property
    def g_star(self) -> torch.Tensor:
        return torch.exp(self.log_g_star)


def degroot_fixed_point(model,
                        sizes: Sequence[int],
                        *,
                        kind: str = "discrete",
                        h=None,
                        algorithm: str = "newton",
                        tol: float = 1e-10,
                        space: Optional[str] = None,
                        quad_degree: int = 5,
                        num_std_devs: float = 3.2,
                        discretization: str = "rouwenhorst",
                        g_init_w: float = DEFAULT_INIT_W,
                        sa_warm_tol: float = 1e-6,
                        sa_warm_maxiter: int = 20000,
                        checkpoint_path: Optional[str] = None,
                        device="cuda",
                        **solver_opts) -> DeGrootSolution:
    """End-to-end float64 solve of the de Groot alternative specification
    on ``device`` (the card unless the caller asks for the CPU).

    Builds the untilted chain on the discretized (``kind="discrete"``)
    or continuous-quadrature (``kind="continuous"``) tier
    (:mod:`.operators.degroot`), then solves T~g = g.  The log space is
    the default; ``algorithm="newton"`` there runs the two-stage recipe:
    successive approximation to ``sa_warm_tol`` (the outer map is stiff
    in theta, so a cold Newton start can stall), then Newton to ``tol``.
    ``space="w"`` solves in g directly (small-theta / cross-check tier).
    The start maps w = ``g_init_w`` through g = ((1-beta) w)^theta.

    ``checkpoint_path`` stores ln g* (meta ``spec="degroot"``,
    ``field="log_g"``, kind, shapes, algorithm, tol, space, h,
    iterations, residual), which the command line's ``simulate`` and
    ``price`` refuse.
    """
    from .operators.degroot import (T_degroot_continuous_factory,
                                    T_degroot_factory)

    space = space or "log"
    theta, beta = model.theta, model.beta
    dev = resolve_device(device)
    if kind == "discrete":
        disc = (discretize_ssy if isinstance(model, SSY)
                else discretize_gcy)(model, tuple(sizes),
                                     method=discretization)
        T = T_degroot_factory(model, disc, h=h, space=space, device=dev)
        grids = None
        shapes = disc.shapes
    elif kind == "continuous":
        make_grids = (build_grid_ssy if isinstance(model, SSY)
                      else build_grid_gcy)
        grids = make_grids(model, *sizes, num_std_devs=num_std_devs)
        T = T_degroot_continuous_factory(model, grids, h=h,
                                         quad_degree=quad_degree,
                                         space=space, device=dev)
        grids = tuple(g.to(dev) for g in grids)
        shapes = tuple(len(g) for g in grids)
    else:
        raise ValueError(f"kind must be 'discrete' or 'continuous', "
                         f"got {kind!r}")

    ell0 = torch.full(tuple(shapes), float(theta) * float(
        np.log((1.0 - beta) * g_init_w)), dtype=torch.float64, device=dev)
    if space == "log":
        x0 = ell0
        if algorithm == "newton":
            x0 = solve(T, x0, method="successive_approx", tol=sa_warm_tol,
                       max_iter=sa_warm_maxiter).x
        res = solve(T, x0, method=algorithm, tol=tol, **solver_opts)
        log_g = res.x
    else:
        res = solve(T, torch.exp(ell0), method=algorithm, tol=tol,
                    **solver_opts)
        log_g = torch.log(res.x)
    sol = DeGrootSolution(log_g_star=log_g, grids=grids, result=res,
                          space=space)
    if checkpoint_path:
        # The stored field is ln g* (scale-safe); the spec/field markers
        # keep the file self-describing beside w* checkpoints.
        h_list = (None if h is None else np.asarray(
            h.cpu() if isinstance(h, torch.Tensor) else h).tolist())
        save_solution(checkpoint_path, model, grids or (), log_g,
                      meta=dict(spec="degroot", field="log_g", kind=kind,
                                shapes=[int(s) for s in shapes],
                                algorithm=algorithm, tol=tol, space=space,
                                h=h_list, iterations=int(res.iterations),
                                residual=float(res.residual)))
    return sol
