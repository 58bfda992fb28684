"""Newton vs Anderson, and interpolation-space effects.

Script equivalent of the reference's ``test_newton.md`` notebook: solver
cross-checks and the w^theta-interpolation vs log-interpolation
comparison.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.newton_experiments
"""

import torch


def main(sizes=(15, 15, 15, 20), interp_sizes=(8, 8, 8, 10),
         num_steps: int = 200_000, device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        SSY, construct_wstar_callable, simulated_w_moments,
        wc_ratio_continuous)

    model = SSY()

    # Cross-solver agreement.
    s_newton = wc_ratio_continuous(model, sizes, algorithm="newton",
                                   tol=1e-9, interp="pre", device=device)
    s_aa = wc_ratio_continuous(model, sizes, algorithm="anderson",
                               tol=1e-9, interp="pre", device=device)
    diff = float(torch.max(torch.abs(s_newton.w_star - s_aa.w_star)))
    print(f"newton vs anderson sup diff: {diff:.2e}")

    # Interpolation-space comparison: the functional form shifts the
    # level at beta ~ 1.
    moments = {}
    for interp, label in (("pre", "w^theta-interp (factored)"),
                          ("post", "w-interp-then-power (reference)"),
                          ("loglin", "log-interp")):
        sol = wc_ratio_continuous(model, interp_sizes, algorithm="newton",
                                  tol=1e-8, interp=interp, device=device)
        f = construct_wstar_callable(sol.w_star, sol.grids, device=device)
        mean, std = simulated_w_moments(model, f, num_steps=num_steps,
                                        device=device)
        moments[interp] = (mean, std)
        print(f"{label:>34}: E[w]={mean:8.2f}  sigma[w]={std:6.2f}")
    return diff, moments


if __name__ == "__main__":
    main()
