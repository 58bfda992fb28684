"""de Groot alternative-specification demo.

The de Groot (2018) aggregator carries preference shocks as a
state-dependent discount factor ``a_t = h(X_t)`` instead of a
multiplicative tilt, which removes the asymptote in the standard
existence condition.  The demo walks three facts:

1. the existence margins differ structurally: the standard condition
   carries the preference-shock growth rate, the alternative only
   ``ln sup h``;
2. at ``h = 1`` with no preference shocks the two specifications agree
   exactly through the closed form ``g* = ((1-beta) w*)^theta``;
3. with shocks on, the h = 1 fixed point's scale explodes like
   ``(O(1))^theta`` (GCY: ln g ~ 97..124), which is why the log tier and
   the SA -> Newton recipe are the production path
   (``drivers.degroot_fixed_point``).

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.degroot_demo
"""

import dataclasses

import torch


def main(shapes=(6, 6, 6, 8), gcy_sizes=(3, 3, 3, 3, 4, 3),
         device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (
        GCY, SSY, T_ssy_factory, degroot_fixed_point, discretize_ssy,
        existence_check, existence_check_degroot, solve)

    # --- 1. existence margins, standard vs alternative ----------------
    model = SSY()
    disc = discretize_ssy(model, shapes)
    std = existence_check(model, disc, device=device)
    alt = existence_check_degroot(model, disc, device=device)
    print("standard  : r(H) =", f"{std.spectral_radius:.6f}",
          " exists:", std.exists_unique)
    print("de Groot  : r(K~) =", f"{alt.spectral_radius:.6f}",
          f" S~ = {alt.S_alt:+.6f}", " exists:", alt.exists_unique)
    for h in (1.0, 0.99, 0.9):
        rep = existence_check_degroot(model, disc, h=h, device=device)
        print(f"  h = {h:4}:  S~ = {rep.S_alt:+.6f}  "
              f"exists_unique = {rep.exists_unique}")

    # --- 2. exact agreement at h=1, s_lam=0 ---------------------------
    noshock = dataclasses.replace(SSY(), s_lam=0.0)
    d0 = discretize_ssy(noshock, shapes)
    w0 = torch.full(shapes, 800.0, dtype=torch.float64, device=device)
    w_star = solve(T_ssy_factory(noshock, d0, device=device), w0,
                   method="newton", tol=1e-11).x
    sol = degroot_fixed_point(noshock, shapes, tol=1e-12, device=device)
    mapped = noshock.theta * torch.log((1 - noshock.beta) * w_star)
    err = float(torch.max(torch.abs(sol.log_g_star - mapped)))
    print(f"\nclosed-form anchor  sup|ln g* - theta ln((1-b)w*)| = {err:.2e}")

    # --- 3. the theta-power scale, and the log tier -------------------
    gcy = GCY()
    sol_g = degroot_fixed_point(gcy, gcy_sizes, kind="continuous",
                                quad_degree=3, tol=1e-11, device=device)
    lg = sol_g.log_g_star
    lo, hi = float(lg.min()), float(lg.max())
    print(f"\nGCY h=1 continuous: converged={sol_g.converged}, "
          f"ln g in [{lo:.1f}, {hi:.1f}]  "
          f"(g ~ e^{lo:.0f}..e^{hi:.0f}: log tier only)")
    return err, sol_g


if __name__ == "__main__":
    main()
