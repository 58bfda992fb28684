"""GCY model demo: discrete and continuous solves plus simulation.

Script equivalent of the reference's GCY drivers (the discrete and the
continuous ``wc_ratio`` solves), then the simulated moments of w*.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.gcy_demo
"""

import time


def main(discrete_shapes=(5, 5, 5, 5, 5, 5),
         continuous_sizes=(6, 6, 6, 6, 8, 6), num_steps: int = 200_000,
         device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        GCY, construct_wstar_callable, simulated_w_moments,
        wc_ratio_continuous, wc_ratio_discrete)

    model = GCY()
    print(f"GCY: beta={model.beta}, gamma={model.gamma}, psi={model.psi}, "
          f"theta={model.theta:.3f}")

    t0 = time.time()
    sol = wc_ratio_discrete(model, discrete_shapes, algorithm="newton",
                            tol=1e-9, device=device)
    print(f"discrete {discrete_shapes} newton: "
          f"iters={sol.result.iterations} "
          f"residual={sol.result.residual:.2e} "
          f"wall={time.time()-t0:.2f}s "
          f"w in [{float(sol.w_star.min()):.1f}, "
          f"{float(sol.w_star.max()):.1f}]")

    t0 = time.time()
    solc = wc_ratio_continuous(model, continuous_sizes, algorithm="newton",
                               tol=1e-8, interp="pre", quad_degree=4,
                               device=device)
    print(f"continuous {continuous_sizes} newton: "
          f"iters={solc.result.iterations} wall={time.time()-t0:.2f}s")

    f = construct_wstar_callable(solc.w_star, solc.grids, device=device)
    mean, std = simulated_w_moments(model, f, num_steps=num_steps,
                                    device=device)
    print(f"simulated E[w]={mean:.2f}, sigma[w]={std:.2f}")
    return sol, solc, (mean, std)


if __name__ == "__main__":
    main()
