from .wstar import construct_wstar_callable
from .simulate import (simulate_states, simulated_w_moments,
                       one_step_w_moments, sdf_factory, sdf_factory_ssy,
                       sdf_factory_gcy)

__all__ = ["construct_wstar_callable", "simulate_states",
           "simulated_w_moments", "one_step_w_moments", "sdf_factory",
           "sdf_factory_ssy", "sdf_factory_gcy"]
