"""End-to-end SSY continuous-state demo.

Script equivalent of the reference's ``ssy_test_continuous.md``
notebook: solve the wealth-consumption ratio on a 15x15x15x20 grid with
quadrature and Monte Carlo expectations, across solvers, compare with
the log-linear approximation, and report simulated moments.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.ssy_continuous_demo
"""

import time

import numpy as np


def main(sizes=(15, 15, 15, 20), mc_sizes=(8, 8, 8, 10),
         mc_draw_size: int = 1000, num_draws: int = 1_000_000,
         num_steps: int = 1_000_000, device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        SSY, construct_wstar_callable, one_step_w_moments,
        simulated_w_moments, ssy_loglinear_factory, wc_ratio_continuous)

    model = SSY()
    print(f"SSY: beta={model.beta}, gamma={model.gamma}, psi={model.psi}, "
          f"theta={model.theta:.3f}")
    center = tuple(s // 2 for s in sizes)

    for algorithm in ("newton", "anderson", "successive_approx"):
        t0 = time.time()
        sol = wc_ratio_continuous(model, sizes, algorithm=algorithm,
                                  tol=1e-8, interp="pre", device=device)
        print(f"{algorithm:>18}: iters={sol.result.iterations:>6} "
              f"residual={sol.result.residual:.2e} "
              f"wall={time.time()-t0:.2f}s "
              f"w* center={float(sol.w_star[center]):.2f}")

    # Monte Carlo expectations.
    t0 = time.time()
    sol_mc = wc_ratio_continuous(model, mc_sizes, algorithm="newton",
                                 tol=1e-6, method="monte_carlo",
                                 interp="post", mc_draw_size=mc_draw_size,
                                 device=device)
    print(f"{'monte_carlo/post':>18}: iters={sol_mc.result.iterations} "
          f"wall={time.time()-t0:.2f}s")

    # Log-linear overlay.
    sol = wc_ratio_continuous(model, sizes, algorithm="newton", tol=1e-8,
                              interp="pre", device=device)
    ll = ssy_loglinear_factory(model)
    center_ll = float(np.exp(ll(np.zeros(4))))
    center_num = float(sol.w_star[center])
    print(f"log-linear w at center: {center_ll:.2f} vs solved "
          f"{center_num:.2f}")

    # One-step moments: the reference's tabulated anchors evaluate w* on
    # 10^6 one-step draws from the origin.  Reference at 15^4 x 20,
    # std 3.2, degree 5, w^theta-interp: E[w]=670.75, sigma[w]=6.60.
    f = construct_wstar_callable(sol.w_star, sol.grids, device=device)
    mean, std = one_step_w_moments(model, f, num_draws=num_draws,
                                   device=device)
    print(f"one-step E[w]={mean:.2f}, sigma[w]={std:.2f} "
          f"(reference anchor: 670.75, 6.60)")

    # Long-path (ergodic) moments.
    mean_p, std_p = simulated_w_moments(model, f, num_steps=num_steps,
                                        device=device)
    print(f"ergodic-path E[w]={mean_p:.2f}, sigma[w]={std_p:.2f}")
    return (mean, std), (mean_p, std_p)


if __name__ == "__main__":
    main()
