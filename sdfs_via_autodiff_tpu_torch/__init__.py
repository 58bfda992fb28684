"""PyTorch + CUDA port of the recursive-utility solver library.

Computes wealth-consumption ratios for long-run-risk models by solving
the Koopmans fixed point

    T(w) = 1 + beta * (H w^theta)^(1/theta)

with autodiff-powered solvers, on an NVIDIA Hopper GPU (hand-written
CUDA kernels for the fast tier) or on the CPU (their plain PyTorch
versions).  The JAX package ``sdfs_via_autodiff_tpu`` is the reference
each part is tested against; this package never imports it or JAX.

Ported so far: the discrete SSY and GCY paths,
``wc_ratio_discrete(SSY() or GCY(), shapes, kernel="tiled", device=...)``.
"""

from .models import SSY, ssy_loglinear_factory, GCY, gcy_loglinear_factory
from .operators import (SSYDiscretization, discretize_ssy, T_ssy_factory,
                        dense_H_ssy, GCYDiscretization, discretize_gcy,
                        T_gcy_factory, dense_H_gcy, gcy_loglinear_parts,
                        TwoPhaseOperands, two_phase_operands_ssy,
                        two_phase_operands_gcy, make_eager_two_phase_T)
from .kernels import (LAUNCHES, make_streamed_T_log, make_tiled_T_log,
                      make_tiled_T_log_ssy, make_tiled_T_log_gcy,
                      streamed_config, streamed_supported)
from .solvers import (SolveResult, solve, solver, successive_approx,
                      newton_solver, bicgstab_mixed)
from .drivers import WCSolution, wc_ratio_discrete, f32_tol_floor
from .interop import model_from_fields, operands_from_numpy

__version__ = "0.1.0"
