"""Scale demo: 10^7-point solves through the float32 CUDA kernels.

* continuous SSY at (56, 56, 56, 64) = 11.2M points, Newton from the
  log-linear baseline (the streamed kernels' batched configuration);
* discrete GCY at 1.0M points through the Kronecker-grouped tiled
  kernels;
* continuous GCY at 18.9M points through the streamed pair kernels
  (coarse-fit additive baseline).

The reference's largest recorded run is 20^4 = 160k points.  On the
CPU (``device="cpu"``) the same paths run the kernels' plain versions.

Run:  python -m sdfs_via_autodiff_tpu_torch.examples.scale_demo [--small]
"""

import math
import sys
import time


def main(small: bool = False, ssy_shape=None, gcy_shape=None,
         gcc_shape=None, device="cuda"):
    from sdfs_via_autodiff_tpu_torch import (GCY, SSY, wc_ratio_continuous,
                                             wc_ratio_discrete)

    ssy_shape = ssy_shape or ((24, 24, 24, 32) if small
                              else (56, 56, 56, 64))
    print(f"-- continuous SSY, {ssy_shape} = "
          f"{math.prod(ssy_shape)/1e6:.2f}M points, tiled kernels, "
          "Newton, f32 --")
    t0 = time.time()
    sol = wc_ratio_continuous(SSY(), ssy_shape, interp="pre",
                              kernel="tiled", algorithm="newton",
                              baseline="loglinear", tol=2e-5, space="log",
                              device=device)
    print(f"  {time.time()-t0:.1f}s: iters={sol.result.iterations} "
          f"residual={sol.result.residual:.2e} "
          f"converged={sol.result.converged}")
    out = [sol]

    gcy_shape = gcy_shape or ((4, 4, 8, 8, 8, 8) if small
                              else (6, 6, 12, 12, 12, 16))
    print(f"-- discrete GCY, {gcy_shape} = "
          f"{math.prod(gcy_shape)/1e6:.2f}M points, Kronecker-grouped "
          "tiled kernels, Newton, f32 --")
    t0 = time.time()
    # theta = -36 amplifies the f32 floor ~2x vs SSY: 3e-5 clears it.
    sol = wc_ratio_discrete(GCY(), gcy_shape, kernel="tiled",
                            algorithm="newton", tol=3e-5, space="log",
                            device=device)
    print(f"  {time.time()-t0:.1f}s: iters={sol.result.iterations} "
          f"residual={sol.result.residual:.2e} "
          f"converged={sol.result.converged}")
    out.append(sol)

    # Continuous GCY through the streamed pair kernels: the conditioned
    # z/z_pi expectations contract per slice.  baseline="coarse" fits
    # ANOVA main effects from a small f64 solve: theta = -36 leaves even
    # the log-linear-normalized residual outside exp's f32 range.
    gcc_shape = gcc_shape or ((8, 8, 4, 4, 128, 4) if small
                              else (16, 8, 12, 12, 128, 8))
    print(f"-- continuous GCY, {gcc_shape} = "
          f"{math.prod(gcc_shape)/1e6:.2f}M points, streamed pair "
          "kernels, Newton, f32 --")
    t0 = time.time()
    sol = wc_ratio_continuous(GCY(), gcc_shape, interp="pre",
                              kernel="tiled", algorithm="newton",
                              baseline="coarse", tol=3e-5, space="log",
                              inner_maxiter=12, device=device)
    print(f"  {time.time()-t0:.1f}s: iters={sol.result.iterations} "
          f"residual={sol.result.residual:.2e} "
          f"converged={sol.result.converged}")
    out.append(sol)
    return out


if __name__ == "__main__":
    main(small="--small" in sys.argv[1:])
