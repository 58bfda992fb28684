"""PyTorch + CUDA port of the recursive-utility solver library.

Computes wealth-consumption ratios for long-run-risk models by solving
the Koopmans fixed point

    T(w) = 1 + beta * (H w^theta)^(1/theta)

with autodiff-powered solvers, on an NVIDIA Hopper GPU (hand-written
CUDA kernels for the fast tier) or on the CPU (their plain PyTorch
versions).  The JAX package ``sdfs_via_autodiff_tpu`` is the reference
each part is tested against; this package never imports it or JAX.

Ported so far: the discrete SSY and GCY paths,
``wc_ratio_discrete(SSY() or GCY(), shapes, kernel="tiled")``; the
continuous SSY and GCY paths, ``wc_ratio_continuous(SSY() or GCY(),
sizes)``, with the float64 factored operator (quadrature, pre-power
interpolation), the node chain (the reference's post-power ``"post"``
and the ``"loglin"`` semantics, quadrature or Monte Carlo), the
whole-solve kernels (``algorithm="fused_sa"``/``"fused_anderson"``), the
post-interp kernel for SSY (``kernel="tiled", interp="post"``) and the
streamed pair kernels for GCY (``kernel="tiled", baseline="coarse"``);
and the SDF pipeline (``construct_wstar_callable``,
``one_step_w_moments``, ``sdf_factory``).
Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from .models import SSY, ssy_loglinear_factory, GCY, gcy_loglinear_factory
from .operators import (SSYDiscretization, discretize_ssy, T_ssy_factory,
                        dense_H_ssy, GCYDiscretization, discretize_gcy,
                        T_gcy_factory, dense_H_gcy, gcy_loglinear_parts,
                        TwoPhaseOperands, two_phase_operands_ssy,
                        two_phase_operands_gcy,
                        two_phase_operands_gcy_continuous,
                        make_eager_two_phase_T, T_gcy_continuous_factory)
from .operators.continuous_ssy import T_ssy_continuous_factory
from .operators.continuous_common import make_gather_T
from .operators.post_interp import (ssy_quadrature_nodes, node_basis_ssy,
                                    make_node_chain_T_ssy,
                                    gcy_quadrature_nodes, node_basis_gcy,
                                    make_node_chain_T_gcy)
from .ops.grids import build_grid_ssy, build_grid_gcy
from .kernels import (LAUNCHES, FUSED_LAUNCHES, make_streamed_T_log,
                      make_tiled_T_log, make_tiled_T_log_ssy,
                      make_tiled_T_log_gcy, make_tiled_T_log_gcy_continuous,
                      streamed_config, streamed_supported, kron_operands_ssy,
                      kron_operands_ssy_continuous, kron_operands_gcy,
                      kron_operands_gcy_continuous,
                      make_xla_T_from_operands, make_fused_T_from_operands,
                      make_fused_T_log_ssy, make_fused_T_log_ssy_continuous,
                      make_fused_T_log_gcy, make_fused_T_log_gcy_continuous,
                      make_fused_solver_from_operands,
                      make_fused_solver_ssy, make_fused_solver_ssy_continuous,
                      make_fused_solver_gcy,
                      make_fused_solver_gcy_continuous,
                      make_fused_anderson_from_operands,
                      make_fused_anderson_ssy,
                      make_fused_anderson_ssy_continuous,
                      make_fused_anderson_gcy_continuous,
                      POST_INTERP_LAUNCHES, post_interp_operands_ssy,
                      make_post_interp_kernel_T_ssy)
from .sdf import (construct_wstar_callable, simulate_states,
                  simulated_w_moments, one_step_w_moments, sdf_factory,
                  sdf_factory_ssy, sdf_factory_gcy)
from .solvers import (SolveResult, solve, solver, successive_approx,
                      newton_solver, bicgstab_mixed, anderson_solver)
from .drivers import (WCSolution, wc_ratio_discrete, wc_ratio_continuous,
                      f32_tol_floor)
from .interop import (model_from_fields, operands_from_numpy,
                      kron_operands_from_numpy, grids_from_numpy,
                      node_set_from_numpy, post_interp_operands_from_numpy,
                      solution_from_numpy)

__version__ = "0.1.0"
