from .discrete_gcy import (GCYDiscretization, discretize_gcy, T_gcy_factory,
                           dense_H_gcy, gcy_loglinear_parts)
from .discrete_ssy import SSYDiscretization, discretize_ssy, T_ssy_factory, dense_H_ssy
from .continuous_common import (hat_basis, expectation_matrix, make_gather_T,
                                normalize_expectation_matrix,
                                additive_profiles, warn_if_f32_range_unsafe)
from .continuous_ssy import next_state_ssy, T_ssy_continuous_factory
from .continuous_gcy import next_state_gcy, T_gcy_continuous_factory
from .degroot import (T_degroot_factory, T_degroot_continuous_factory,
                      existence_check_degroot)
from .two_phase import (TwoPhaseOperands, two_phase_operands_ssy,
                        two_phase_operands_ssy_continuous,
                        two_phase_operands_gcy,
                        two_phase_operands_gcy_continuous,
                        conjugate_to_shared, make_eager_two_phase_T)

__all__ = [
    "SSYDiscretization", "discretize_ssy", "T_ssy_factory", "dense_H_ssy",
    "GCYDiscretization", "discretize_gcy", "T_gcy_factory", "dense_H_gcy",
    "gcy_loglinear_parts",
    "TwoPhaseOperands", "two_phase_operands_ssy",
    "two_phase_operands_ssy_continuous", "two_phase_operands_gcy",
    "two_phase_operands_gcy_continuous", "conjugate_to_shared",
    "make_eager_two_phase_T", "hat_basis", "expectation_matrix",
    "normalize_expectation_matrix", "additive_profiles", "make_gather_T",
    "warn_if_f32_range_unsafe", "next_state_ssy", "T_ssy_continuous_factory",
    "next_state_gcy", "T_gcy_continuous_factory",
    "T_degroot_factory", "T_degroot_continuous_factory",
    "existence_check_degroot",
]
