"""Calibration-gradient demo: differentiate the solved W/C ratio in the
model parameters through the fixed point.

``wc_ratio_differentiable`` wraps the solve in the implicit function
theorem: the gradient of any scalar functional of w* costs one solve
plus one adjoint Krylov solve, however many iterations the solver ran.
The demo checks the gradient of a moment loss against a
finite-difference re-solve, prices a one-parameter sensitivity on the
forward-mode path, and recovers a perturbed (beta, gamma) from one-step
simulated moments.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.calibration_gradient
"""

import dataclasses
import time

import torch


def main(sizes=(10, 10, 10, 12), num_draws: int = 20000, device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        SSY, calibrate_moments, one_step_moments_differentiable,
        wc_ratio_differentiable)
    from sdfs_via_autodiff_tpu_torch.operators.continuous_common import (
        mc_draws)
    from sdfs_via_autodiff_tpu_torch.operators.continuous_ssy import (
        _factored_T)
    from sdfs_via_autodiff_tpu_torch.solvers import implicit_sensitivity

    model = SSY()
    wc_fn, p0 = wc_ratio_differentiable(
        model, sizes, fields=("beta", "gamma", "psi"), quad_degree=5,
        tol=1e-10, device=device)

    target = 6.6                      # target mean log W/C ratio
    loss = lambda p: (torch.mean(torch.log(wc_fn(p))) - target) ** 2

    t0 = time.time()
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    val = loss(p)
    grad = dict(zip(p, torch.autograd.grad(val, list(p.values()))))
    dt = time.time() - t0
    print(f"loss {float(val.detach()):.6f}; gradient in {dt:.1f}s "
          "(one solve + one adjoint Krylov solve):")
    for k, v in grad.items():
        print(f"  dL/d{k:<6} = {float(v):+.4f}")

    # Finite-difference check on beta (two full re-solves).
    eps = 1e-7
    pp, pm = dict(p0), dict(p0)
    pp["beta"] = p0["beta"] + eps
    pm["beta"] = p0["beta"] - eps
    fd = (float(loss(pp)) - float(loss(pm))) / (2 * eps)
    rel = abs(fd - float(grad["beta"])) / max(abs(fd), 1e-30)
    print(f"FD check on beta: implicit {float(grad['beta']):+.4f} "
          f"vs FD {fd:+.4f}  (rel diff {rel:.1e})")

    # Forward mode: mean-log-w sensitivity to gamma alone, on the grids
    # the differentiable map collocates on.
    grids = wc_fn.grids

    def T_of_p(q, x):
        return _factored_T(dataclasses.replace(model, gamma=q["gamma"]),
                           grids, 5, "log", torch.float64, None,
                           device=device)(x)

    ell_star = torch.log(wc_fn(p0))
    dx = implicit_sensitivity(T_of_p, {"gamma": p0["gamma"]},
                              {"gamma": 1.0}, ell_star)
    print(f"d mean(log w)/d gamma = {float(torch.mean(dx)):+.4f} "
          "(forward mode, one sensitivity solve)")

    # Moment matching: perturb (beta, gamma), then recover them from the
    # one-step simulated moments by Gauss-Newton on the implicit
    # gradients.
    draws = mc_draws(4, num_draws, 1234)
    mu, sd = one_step_moments_differentiable(model, grids, wc_fn(p0), draws)
    start = dataclasses.replace(model, beta=0.9985, gamma=9.5)
    t0 = time.time()
    cal, info = calibrate_moments(
        start, sizes, {"mean": float(mu), "std": float(sd)},
        fields=("beta", "gamma"), quad_degree=5, tol=1e-10,
        num_draws=num_draws, device=device)
    print(f"moment matching: beta {start.beta} -> {cal.beta:.6f} "
          f"(truth {model.beta}), gamma {start.gamma} -> {cal.gamma:.4f} "
          f"(truth {model.gamma}) in {info['steps']} Gauss-Newton steps, "
          f"{time.time()-t0:.0f}s")
    return grad, cal


if __name__ == "__main__":
    main()
