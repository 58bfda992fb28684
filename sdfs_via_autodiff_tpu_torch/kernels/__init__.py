from .streamed_two_phase import (LAUNCHES, make_streamed_T_log, pass_b,
                                 pass_b_plain, pass_c, pass_c_plain,
                                 pass_b_deferred, pass_b_deferred_plain,
                                 pass_c_deferred, pass_c_deferred_plain,
                                 streamed_config, streamed_supported)
from .tiled_two_phase import (make_tiled_T_log, make_tiled_T_log_ssy,
                              make_tiled_T_log_gcy)
from .fused_discrete import LAUNCHES as FUSED_LAUNCHES
from .fused_discrete import (fused_T, fused_T_plain, kron_operands_ssy,
                             kron_operands_ssy_continuous, kron_operands_gcy,
                             make_xla_T_from_operands,
                             make_fused_T_from_operands, make_fused_T_log_ssy,
                             make_fused_T_log_ssy_continuous,
                             make_fused_T_log_gcy)
from .solver_kernel import (fused_sa, fused_sa_plain,
                            make_fused_solver_from_operands,
                            make_fused_solver_ssy,
                            make_fused_solver_ssy_continuous,
                            make_fused_solver_gcy)
from .anderson_kernel import (fused_anderson, fused_anderson_plain,
                              make_fused_anderson_from_operands,
                              make_fused_anderson_ssy,
                              make_fused_anderson_ssy_continuous)

__all__ = ["LAUNCHES", "make_streamed_T_log", "pass_b", "pass_b_plain",
           "pass_c", "pass_c_plain", "pass_b_deferred",
           "pass_b_deferred_plain", "pass_c_deferred",
           "pass_c_deferred_plain", "streamed_config", "streamed_supported",
           "make_tiled_T_log", "make_tiled_T_log_ssy",
           "make_tiled_T_log_gcy", "FUSED_LAUNCHES", "fused_T",
           "fused_T_plain", "kron_operands_ssy",
           "kron_operands_ssy_continuous", "kron_operands_gcy",
           "make_xla_T_from_operands", "make_fused_T_from_operands",
           "make_fused_T_log_ssy", "make_fused_T_log_ssy_continuous",
           "make_fused_T_log_gcy", "fused_sa", "fused_sa_plain",
           "make_fused_solver_from_operands", "make_fused_solver_ssy",
           "make_fused_solver_ssy_continuous", "make_fused_solver_gcy",
           "fused_anderson", "fused_anderson_plain",
           "make_fused_anderson_from_operands", "make_fused_anderson_ssy",
           "make_fused_anderson_ssy_continuous"]
