"""Moment-matching calibration on implicit-function-theorem gradients.

PyTorch port of ``sdfs_via_autodiff_tpu/calibrate.py``.  The
reference's validation anchors are simulated moments of w* — E[w] and
sigma[w] over the one-step-ahead state distribution from the origin.
With w*(p) differentiable through the fixed point
(:mod:`.solvers.implicit`), moment matching is a smooth least-squares
problem

    min_p  || moments(w*(p)) - targets ||^2,

solved by damped Gauss-Newton (Levenberg-Marquardt), where each
Jacobian row is one reverse pass = one adjoint Krylov solve.  The moment
pipeline differentiates end to end: solve -> multilinear interpolation
of w* at the one-step-ahead states -> mean/std, with the ``next_state``
step taking the overridden fields, so dynamics-field calibrations move
the simulated states too.

The draws come from a ``torch.Generator`` seeded with ``seed``
(``operators.continuous_common.mc_draws``), not the JAX package's PRNG
stream: the two calibrations agree in distribution, and draw by draw
only through :func:`one_step_moments_differentiable` fed the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import resolve_device
from .drivers import wc_ratio_differentiable
from .models.ssy import SSY
from .operators.continuous_common import mc_draws
from .ops.interp import lin_interp

__all__ = ["calibrate_moments", "one_step_moments_differentiable"]

_F64 = torch.float64


def _next_state_fn(model):
    if isinstance(model, SSY):
        from .operators.continuous_ssy import next_state_ssy
        return next_state_ssy, 4
    from .operators.continuous_gcy import next_state_gcy
    return next_state_gcy, 6


def one_step_moments_differentiable(model, grids, w_grid, draws,
                                    overrides: Optional[Dict] = None):
    """(E[w], sigma[w]) over the one-step-ahead distribution from the
    origin — the reference's anchor methodology — as a pair of 0-d
    tensors differentiable in the field values ``w_grid`` and in the
    model ``overrides`` (the state step takes them).  ``draws`` (dim, N)
    is a tensor or an array; the computation runs on ``w_grid``'s
    device in float64, the standard deviation the population one.
    """
    m = dataclasses.replace(model, **overrides) if overrides else model
    step, dim = _next_state_fn(m)
    dev = w_grid.device
    draws = torch.as_tensor(draws, dtype=_F64).to(dev)
    grids = tuple(torch.as_tensor(g).to(device=dev, dtype=_F64)
                  for g in grids)
    x0 = torch.zeros(dim, dtype=_F64, device=dev)
    x_next = step(m, x0, draws)                    # (dim, n_draws)
    w = lin_interp(x_next, w_grid, grids)
    return torch.mean(w), torch.std(w, correction=0)


def calibrate_moments(model,
                      grid_sizes: Sequence[int],
                      targets: Dict[str, float],
                      *,
                      fields: Sequence[str] = ("beta", "gamma"),
                      kind: str = "continuous",
                      num_draws: int = 50_000,
                      seed: int = 1234,
                      max_steps: int = 20,
                      rtol: float = 1e-8,
                      xtol: float = 1e-10,
                      init_damping: float = 1e-6,
                      verbose: bool = False,
                      device="cuda",
                      **diff_opts):
    """Calibrate the named model ``fields`` on ``device`` so the one-step
    simulated moments of w* hit ``targets`` (keys among
    ``{"mean", "std"}``).

    Damped Gauss-Newton on the normalized residuals: each iteration costs
    one fixed-point solve per damping trial (which also gives the next
    residual) plus ``len(targets)`` adjoint Krylov solves for the
    Jacobian, one reverse pass per moment through the graph held from
    the accepted point, so no primal solve is repeated.  Returns
    ``(calibrated_model, info)``; ``info`` carries the residual and
    parameter history and the convergence flag.

    Continuous kind only (the anchor methodology interpolates a
    continuous field).  The solve grids stay at the base calibration
    (the implicit solve's collocation convention) while the moment
    pipeline's state step moves with dynamics-field updates.  Extra
    keyword arguments go to :func:`.drivers.wc_ratio_differentiable`.
    """
    for k in targets:
        if k not in ("mean", "std"):
            raise ValueError(f"unknown target {k!r} (want mean/std)")
    if not targets:
        raise ValueError("empty targets")
    if len(targets) > len(fields):
        raise ValueError(f"{len(targets)} targets need >= that many "
                         f"fields; got {list(fields)}")
    if kind != "continuous":
        # The discrete z-ladders are state-dependent, not a tensor-product
        # grid, so multilinear interpolation over them is ill-posed.
        raise ValueError("calibrate_moments requires kind='continuous'")

    dev = resolve_device(device)
    wc_fn, p0 = wc_ratio_differentiable(model, grid_sizes, fields=fields,
                                        kind=kind, device=dev, **diff_opts)
    _, dim = _next_state_fn(model)
    draws = mc_draws(dim, num_draws, seed).to(dev)
    grids = wc_fn.grids

    names = list(fields)
    keys_t = [k for k in ("mean", "std") if k in targets]
    scale = np.maximum(1.0, np.abs(np.array([targets[k] for k in keys_t])))

    def residual(pvec):
        p = {n: pvec[i] for i, n in enumerate(names)}
        mu, sd = one_step_moments_differentiable(model, grids, wc_fn(p),
                                                 draws, overrides=p)
        vals = {"mean": mu, "std": sd}
        return torch.stack([(vals[k] - targets[k]) / float(s)
                            for k, s in zip(keys_t, scale)])

    def evaluate(pvec_np):
        """The residual at a point, with its graph held for the
        Jacobian's reverse passes."""
        pvec = torch.tensor(pvec_np, dtype=_F64, requires_grad=True)
        return pvec, residual(pvec)

    def jac_rows(pvec, r):
        return np.stack([
            torch.autograd.grad(r[k], pvec, retain_graph=True)[0].numpy()
            for k in range(len(keys_t))])

    pnp = np.array([float(p0[n]) for n in names])
    pvec, r = evaluate(pnp)
    rn = r.detach().cpu().numpy()
    cost = float(np.sum(rn ** 2))
    lam = init_damping
    history = [dict(step=0, cost=cost, accepted=True,
                    p={n: float(v) for n, v in zip(names, pnp)})]
    converged = cost <= rtol ** 2
    for it in range(1, max_steps + 1):
        if converged:
            break
        J = jac_rows(pvec, r)
        accepted = False
        for _ in range(8):                       # LM damping adaptation
            A = J.T @ J + lam * np.eye(len(names))
            dp = -np.linalg.solve(A, J.T @ rn)
            cand = pnp + dp
            pvec_c, r_c = evaluate(cand)
            rn_c = r_c.detach().cpu().numpy()
            cost_new = float(np.sum(rn_c ** 2))
            if np.isfinite(cost_new) and cost_new < cost:
                pnp, pvec, r, rn, cost = cand, pvec_c, r_c, rn_c, cost_new
                lam = max(lam / 4.0, 1e-12)
                accepted = True
                break
            lam *= 8.0
        history.append(dict(step=it, cost=cost, accepted=accepted,
                            p={n: float(v) for n, v in zip(names, pnp)}))
        if verbose:
            print(f"[calibrate] step {it}: cost {cost:.3e} lam {lam:.1e}")
        if not accepted:
            break
        if cost <= rtol ** 2 or float(np.linalg.norm(dp)) <= \
                xtol * (1.0 + float(np.linalg.norm(pnp))):
            converged = True

    calibrated = dataclasses.replace(
        model, **{n: float(v) for n, v in zip(names, pnp)})
    info = dict(converged=bool(converged), cost=cost,
                steps=sum(1 for hh in history[1:] if hh["accepted"]),
                history=history)
    return calibrated, info
