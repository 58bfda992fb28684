"""Asset pricing from the stochastic discount factor.

PyTorch port of ``sdfs_via_autodiff_tpu/sdf/pricing.py``: conditional
SDF expectations and the risk-free rate

    r_f(x) = -log E_x[ M' ],

with the expectation over the state shocks taken by tensor-product
Gauss-Hermite quadrature through the solved w*, and the consumption
shock xi integrated in closed form: in

    M' = beta^theta e^{theta h_lam'} g_c^{-gamma} (w'/(w-1))^{theta-1},

only g_c = exp(mu_c + z + sigma_c xi) depends on xi, which is
independent of the state innovations, so

    E_x[M'] = exp(-gamma (mu_c + z) + gamma^2 sigma_c^2 / 2)
              * E_states[ beta^theta e^{theta h_lam'}
                          (w'/(w-1))^{theta-1} ].

Plain tensor code: the result differentiates in w* (and in model fields
passed as tensors), so a gradient flows from a price through an
implicit solve (``drivers.wc_ratio_differentiable``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import resolve_device
from ..models.gcy import GCY
from ..models.ssy import SSY
from ..operators.continuous_gcy import next_state_gcy
from ..operators.continuous_ssy import next_state_ssy
from ..ops.quadrature import tensor_quadrature_normal
from .simulate import _z_index

__all__ = ["expected_sdf", "risk_free_rate",
           "expected_sdf_ssy", "risk_free_rate_ssy",
           "expected_sdf_gcy", "risk_free_rate_gcy"]

_F64 = torch.float64


def _family(model):
    if isinstance(model, SSY):
        return next_state_ssy, 4
    if isinstance(model, GCY):
        return next_state_gcy, 6
    raise TypeError(f"unsupported model {type(model).__name__}")


def expected_sdf(model, w_star_func: Callable, degree: int = 5, *,
                 device="cuda") -> Callable:
    """Build ``x -> E_x[M']`` (SSY and GCY) on ``device``, in float64.

    The state innovations take a degree^dim tensor-product Gauss-Hermite
    rule (dim = 4 for SSY, 6 for GCY); the consumption shock integrates
    in closed form (module docstring).  ``w_star_func`` maps states
    (dim,) or (dim, Q) to w*; the callable takes one state ``x`` of
    shape (dim,) and returns a 0-d tensor.
    """
    next_state, dim = _family(model)
    dev = resolve_device(device)
    nodes, weights = tensor_quadrature_normal([degree] * dim)
    nodes = torch.as_tensor(nodes, dtype=_F64, device=dev)       # (dim, Q)
    weights = torch.as_tensor(weights, dtype=_F64, device=dev)   # (Q,)
    theta, beta, gamma = model.theta, model.beta, model.gamma
    zi = _z_index(model)

    def e_sdf(x):
        x = torch.as_tensor(x, dtype=_F64).to(dev)
        x_next = next_state(model, x[:, None], nodes)             # (dim, Q)
        w_now = w_star_func(x)
        w_next = w_star_func(x_next)                              # (Q,)
        m_states = (beta ** theta * torch.exp(theta * x_next[0])
                    * (w_next / (w_now - 1.0)) ** (theta - 1.0))
        sigma_c = model.phi_c * torch.exp(x[1])
        cons = torch.exp(-gamma * (model.mu_c + x[zi])
                         + 0.5 * gamma ** 2 * sigma_c ** 2)
        return cons * torch.dot(m_states, weights)

    return e_sdf


def risk_free_rate(model, w_star_func: Callable, degree: int = 5, *,
                   device="cuda") -> Callable:
    """``x -> r_f(x) = -log E_x[M']`` (per model period)."""
    e_sdf = expected_sdf(model, w_star_func, degree, device=device)
    return lambda x: -torch.log(e_sdf(x))


def expected_sdf_ssy(model: SSY, w_star_func: Callable, degree: int = 5, *,
                     device="cuda") -> Callable:
    """Family-named alias of :func:`expected_sdf`."""
    return expected_sdf(model, w_star_func, degree, device=device)


def risk_free_rate_ssy(model: SSY, w_star_func: Callable, degree: int = 5,
                       *, device="cuda") -> Callable:
    """Family-named alias of :func:`risk_free_rate`."""
    return risk_free_rate(model, w_star_func, degree, device=device)


def expected_sdf_gcy(model: GCY, w_star_func: Callable, degree: int = 3, *,
                     device="cuda") -> Callable:
    """Family-named alias of :func:`expected_sdf` (GCY default degree 3)."""
    return expected_sdf(model, w_star_func, degree, device=device)


def risk_free_rate_gcy(model: GCY, w_star_func: Callable, degree: int = 3,
                       *, device="cuda") -> Callable:
    """Family-named alias of :func:`risk_free_rate`."""
    return risk_free_rate(model, w_star_func, degree, device=device)
