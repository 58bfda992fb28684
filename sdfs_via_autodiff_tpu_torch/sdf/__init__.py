from .wstar import construct_wstar_callable
from .simulate import (simulate_states, simulated_w_moments,
                       one_step_w_moments, sdf_factory, sdf_factory_ssy,
                       sdf_factory_gcy)
from .pricing import (expected_sdf, risk_free_rate,
                      expected_sdf_ssy, risk_free_rate_ssy,
                      expected_sdf_gcy, risk_free_rate_gcy)

__all__ = ["construct_wstar_callable", "simulate_states",
           "simulated_w_moments", "one_step_w_moments", "sdf_factory",
           "sdf_factory_ssy", "sdf_factory_gcy", "expected_sdf",
           "risk_free_rate", "expected_sdf_ssy", "risk_free_rate_ssy",
           "expected_sdf_gcy", "risk_free_rate_gcy"]
