"""SDF pricing demo: solve w*, build the SDF, price the risk-free asset
across the long-run-growth (z) grid.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.pricing_demo
"""

import torch


def main(sizes=(15, 15, 15, 20), device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        SSY, construct_wstar_callable, risk_free_rate_ssy,
        wc_ratio_continuous)

    model = SSY()
    sol = wc_ratio_continuous(model, sizes, algorithm="newton", tol=1e-9,
                              interp="pre", device=device)
    f = construct_wstar_callable(sol.w_star, sol.grids, device=device)
    rf = risk_free_rate_ssy(model, f, device=device)
    n_z = sizes[3]
    rates = []
    print("monthly risk-free rate across the long-run-growth (z) grid:")
    for j in sorted({0, n_z // 4, n_z // 2, 3 * n_z // 4, n_z - 1}):
        z = float(sol.grids[3][j])
        r = float(rf(torch.tensor([0.0, 0.0, 0.0, z], dtype=torch.float64)))
        rates.append(r)
        print(f"  z = {z:+.5f}: r_f = {r*100:6.3f}% /month "
              f"({(1+r)**12-1:6.1%} /yr)")
    return rates


if __name__ == "__main__":
    main()
