"""Calibration sweep demo: many parameterizations of one family.

``wc_ratio_sweep`` builds each calibration's grids and factored
quadrature operator and solves the members one after another on the
card (the JAX package vmaps them under one compile); a gamma sweep like
this one is the moment-matching workflow.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.sweep_demo
"""

import dataclasses
import time

import torch


def main(sizes=(10, 10, 10, 12), gammas=(7.5, 8.0, 8.5, 8.89, 9.5),
         device="cuda"):
    from sdfs_via_autodiff_tpu_torch import SSY, wc_ratio_sweep

    models = [dataclasses.replace(SSY(), gamma=g) for g in gammas]
    t0 = time.time()
    w, res, _ = wc_ratio_sweep(models, sizes, quad_degree=5, tol=1e-9,
                               device=device)
    dt = time.time() - t0
    print(f"solved {len(models)} calibrations: {dt:.1f}s total "
          f"({dt/len(models):.2f}s each)")
    for g, wi, it, conv in zip(gammas, w, res.iterations, res.converged):
        print(f"  gamma={g:5.2f}: iters={int(it):2d} "
              f"converged={bool(conv)} "
              f"E-ish[w] ~ {float(torch.mean(wi)):8.2f} "
              f"w in [{float(wi.min()):7.2f}, {float(wi.max()):8.2f}]")
    return w, res


if __name__ == "__main__":
    main()
