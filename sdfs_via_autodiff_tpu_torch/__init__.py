"""PyTorch + CUDA port of the recursive-utility solver library.

Computes wealth-consumption ratios for long-run-risk models by solving
the Koopmans fixed point

    T(w) = 1 + beta * (H w^theta)^(1/theta)

with autodiff-powered solvers, on an NVIDIA Hopper GPU (hand-written
CUDA kernels for the fast tier) or on the CPU (their plain PyTorch
versions).  The JAX package ``sdfs_via_autodiff_tpu`` is the reference
each part is tested against; this package never imports it or JAX.

Ported so far: the discrete SSY and GCY paths,
``wc_ratio_discrete(SSY() or GCY(), shapes, kernel="tiled")``, plain or
baseline-normalized (``baseline="loglinear"``), on the streamed or the
strip kernels (``make_tiled_T_log(..., engine=...)``); the
continuous SSY and GCY paths, ``wc_ratio_continuous(SSY() or GCY(),
sizes)``, with the float64 factored operator (quadrature, pre-power
interpolation), the node chain (the reference's post-power ``"post"``
and the ``"loglin"`` semantics, quadrature or Monte Carlo), the
whole-solve kernels (``algorithm="fused_sa"``/``"fused_anderson"``), the
post-interp kernel for SSY (``kernel="tiled", interp="post"``) and the
streamed pair kernels for GCY (``kernel="tiled", baseline="coarse"``);
the SDF pipeline (``construct_wstar_callable``,
``one_step_w_moments``, ``sdf_factory``) and pricing (``expected_sdf``,
``risk_free_rate``); the solvers (Newton with BiCGStab, GMRES or a dense
inner solve and a float32 ``tangent_T``, successive approximation,
Anderson, L-BFGS ``"gd"``), ``polish`` in both drivers (a float64
Newton refinement of a fast solve), and calibration
(``wc_ratio_differentiable`` on implicit differentiation,
``calibrate_moments``); checkpoints in the JAX package's format
(``checkpoint_path``, ``save_solution``, ``load_solution``,
``construct_wstar_callable(datafile=)``), the spectral existence checks
(``existence_check``, ``stability_decomposition``), the de Groot
specification (``degroot_fixed_point``), calibration sweeps
(``wc_ratio_sweep``), profiling (``utils.trace``, ``utils.timed_solve``),
the ``sdfs-torch`` command line (``cli.py``) and grid sharding on
``torch.distributed`` (``parallel``: meshes, the sharded operators, the
single-device eager operators on a DTensor iterate, and the solvers and
implicit gradients on their shards).
Every entry point runs on the card unless the caller passes
``device="cpu"``.
"""

from .models import SSY, ssy_loglinear_factory, GCY, gcy_loglinear_factory
from .operators import (SSYDiscretization, discretize_ssy, T_ssy_factory,
                        dense_H_ssy, GCYDiscretization, discretize_gcy,
                        T_gcy_factory, dense_H_gcy, gcy_loglinear_parts,
                        TwoPhaseOperands, two_phase_operands_ssy,
                        two_phase_operands_ssy_continuous,
                        two_phase_operands_gcy,
                        two_phase_operands_gcy_continuous,
                        conjugate_to_shared, make_eager_two_phase_T,
                        T_gcy_continuous_factory, T_degroot_factory,
                        T_degroot_continuous_factory,
                        existence_check_degroot)
from .operators.continuous_ssy import T_ssy_continuous_factory
from .operators.continuous_common import make_gather_T
from .operators.post_interp import (ssy_quadrature_nodes, node_basis_ssy,
                                    make_node_chain_T_ssy,
                                    gcy_quadrature_nodes, node_basis_gcy,
                                    make_node_chain_T_gcy)
from .ops.grids import build_grid_ssy, build_grid_gcy
from .kernels import (LAUNCHES, FUSED_LAUNCHES, STRIP_LAUNCHES,
                      make_streamed_T_log, streamed_coverable, tiled_engine,
                      make_tiled_T_log, make_tiled_T_log_ssy,
                      make_tiled_T_log_ssy_continuous, make_tiled_T_log_gcy,
                      make_tiled_T_log_gcy_continuous,
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
                  sdf_factory_ssy, sdf_factory_gcy, expected_sdf,
                  risk_free_rate, expected_sdf_ssy, risk_free_rate_ssy,
                  expected_sdf_gcy, risk_free_rate_gcy)
from .solvers import (SolveResult, solve, solver, successive_approx,
                      newton_solver, bicgstab_mixed, gmres, anderson_solver,
                      gradient_solver, implicit_fixed_point,
                      implicit_sensitivity)
from .drivers import (WCSolution, wc_ratio_discrete, wc_ratio_continuous,
                      wc_ratio_continuation, wc_ratio_sweep,
                      wc_ratio_differentiable, prolong_w, f32_tol_floor,
                      DeGrootSolution, degroot_fixed_point)
from .utils import (save_solution, load_solution, existence_check,
                    stability_decomposition)
from .calibrate import calibrate_moments, one_step_moments_differentiable
from .interop import (model_from_fields, operands_from_numpy,
                      kron_operands_from_numpy, grids_from_numpy,
                      node_set_from_numpy, post_interp_operands_from_numpy,
                      solution_from_numpy)

__version__ = "0.1.0"
