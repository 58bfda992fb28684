from .discrete_ssy import SSYDiscretization, discretize_ssy, T_ssy_factory, dense_H_ssy
from .two_phase import TwoPhaseOperands, two_phase_operands_ssy, make_eager_two_phase_T

__all__ = [
    "SSYDiscretization", "discretize_ssy", "T_ssy_factory", "dense_H_ssy",
    "TwoPhaseOperands", "two_phase_operands_ssy", "make_eager_two_phase_T",
]
