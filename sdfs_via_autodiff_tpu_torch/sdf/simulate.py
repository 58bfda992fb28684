"""State-path simulation and simulated moments of the W/C ratio.

PyTorch port of ``sdfs_via_autodiff_tpu/sdf/simulate.py``.  The reference
validates a solution by simulating the state, evaluating the
interpolated w* along it and tabulating mean and standard deviation; its
published E[w] / sigma[w] anchors come from one ``next_state`` step out
of the origin with 10^6 draws (:func:`one_step_w_moments`).  The
Epstein-Zin SDF built from w* is exposed for pricing.

Shocks come from a ``torch.Generator`` seeded with ``seed``, drawn on the
CPU in float64 and moved to the device (``continuous_common.mc_draws``):
the same draws on every device, but not the JAX package's PRNG stream,
so the two packages' simulated moments agree within sampling error, not
draw by draw.  Explicit ``shocks`` / ``draws`` replace the generator for
a comparison on the same states.

On the card the path runs in chunks of :data:`SIM_CHUNK` steps, each
after the first replaying one captured CUDA graph
(:func:`..utils.graphs.run_chunks`): a step is a dozen launches on four
numbers, so a plain Python loop is bound by the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..models.gcy import GCY
from ..models.ssy import SSY
from ..operators.continuous_common import mc_draws
from ..operators.continuous_gcy import next_state_gcy
from ..operators.continuous_ssy import next_state_ssy
from ..utils.graphs import run_chunks

__all__ = ["simulate_states", "simulated_w_moments", "one_step_w_moments",
           "sdf_factory", "sdf_factory_ssy", "sdf_factory_gcy"]

_F64 = torch.float64
# Steps per chunk of a simulated path (one captured CUDA graph).
SIM_CHUNK = 1024


def _next_state_for(model):
    if isinstance(model, SSY):
        return lambda x, s: next_state_ssy(model, x, s), 4
    if isinstance(model, GCY):
        return lambda x, s: next_state_gcy(model, x, s), 6
    raise TypeError(f"unsupported model {type(model).__name__}")


def simulate_states(model, num_steps: int, *, seed: int = 1234, x0=None,
                    dtype: torch.dtype = _F64, device="cuda",
                    shocks=None) -> torch.Tensor:
    """Simulate a path of the model's state vector on ``device``: returns
    (dim, num_steps), the states after steps 1..num_steps from ``x0``
    (the origin when None).

    A loop of the model's ``next_state`` steps, as the JAX package's
    ``lax.scan``; no step reads back to the host.  On a CUDA device
    the chunks after the first replay a captured CUDA graph of the
    loop's kernels (bitwise the loop's path).  ``shocks``
    (num_steps, dim) replaces the generator's draws.
    """
    step, dim = _next_state_for(model)
    dev = resolve_device(device)
    eps = (mc_draws(dim, num_steps, seed).T if shocks is None
           else torch.as_tensor(shocks).reshape(num_steps, dim))
    eps = eps.to(device=dev, dtype=dtype).contiguous()
    x = (torch.zeros(dim, dtype=dtype, device=dev) if x0 is None
         else torch.as_tensor(x0).to(device=dev,
                                     dtype=dtype).reshape(dim).clone())
    path = torch.empty((num_steps, dim), dtype=dtype, device=dev)
    chunk = max(1, min(SIM_CHUNK, num_steps))
    eps_c = torch.empty((chunk, dim), dtype=dtype, device=dev)
    path_c = torch.empty((chunk, dim), dtype=dtype, device=dev)

    def steps(n):
        def run():
            y = x
            for t in range(n):
                y = step(y, eps_c[t])
                path_c[t] = y
            x.copy_(y)
        return run

    def load(c, n=chunk):
        eps_c[:n].copy_(eps[c * chunk:c * chunk + n])

    def store(c, n=chunk):
        path[c * chunk:c * chunk + n].copy_(path_c[:n])

    full, rest = divmod(num_steps, chunk)
    run_chunks(steps(chunk), full, before=load, after=store,
               graphs=dev.type == "cuda")
    if rest:
        load(full, rest)
        steps(rest)()
        store(full, rest)
    return path.T


def _moments(w: torch.Tensor) -> Tuple[float, float]:
    """Mean and (population) standard deviation, as numpy's."""
    w = w.to(_F64)
    mean = w.mean()
    return float(mean), float(torch.sqrt(((w - mean) ** 2).mean()))


def simulated_w_moments(model, w_star_func: Callable,
                        num_steps: int = 1_000_000, *, seed: int = 1234,
                        burn_in: int = 1000, device="cuda",
                        shocks=None) -> Tuple[float, float]:
    """Mean and standard deviation of w* along a simulated state path of
    ``num_steps`` steps after ``burn_in`` (:func:`simulate_states`);
    ``shocks`` (num_steps + burn_in, dim) replaces the generator's
    draws."""
    path = simulate_states(model, num_steps + burn_in, seed=seed,
                           device=device, shocks=shocks)
    return _moments(w_star_func(path[:, burn_in:]))


def one_step_w_moments(model, w_star_func: Callable,
                       num_draws: int = 1_000_000, *, seed: int = 1234,
                       x0=None, device="cuda",
                       draws=None) -> Tuple[float, float]:
    """Mean and standard deviation of w* over the one-step-ahead state
    distribution from ``x0`` (the origin when None): the methodology of
    the reference's tabulated E[w], sigma[w] anchors — one ``next_state``
    step with ``num_draws`` joint draws, then w* interpolated at those
    states.  ``draws`` (dim, N) replaces the generator's draws."""
    step, dim = _next_state_for(model)
    dev = resolve_device(device)
    eps = (mc_draws(dim, num_draws, seed) if draws is None
           else torch.as_tensor(np.array(draws, np.float64))).to(dev)
    x = (torch.zeros(dim, dtype=_F64, device=dev) if x0 is None
         else torch.as_tensor(x0).to(device=dev, dtype=_F64))
    return _moments(w_star_func(step(x[:, None], eps)))


def _z_index(model) -> int:
    """Index of the persistent growth state z: SSY (h_lam, h_c, h_z, z)
    -> 3; GCY (h_lam, h_c, h_z, h_zpi, z, z_pi) -> 4.  Both read sigma_c
    = phi_c*exp(h_c) from index 1 and h_lam' from index 0."""
    if isinstance(model, SSY):
        return 3
    if isinstance(model, GCY):
        return 4
    raise TypeError(f"unsupported model {type(model).__name__}")


def sdf_factory(model, w_star_func: Callable) -> Callable:
    """Epstein-Zin stochastic discount factor (both families).

    With preference-shock ratio lambda'/lambda = exp(h_lam'),

        M' = beta^theta * exp(theta*h_lam') * (g_c')^(-gamma)
             * ( w(x') / (w(x) - 1) )^(theta - 1)

    where g_c' = exp(mu_c + z + sigma_c*xi') is consumption growth out of
    the current state (sigma_c = phi_c*exp(h_c)) and w the
    wealth-consumption ratio.  Returns ``m(x, x_next, xi)`` evaluating
    the SDF along a transition.
    """
    zi = _z_index(model)
    theta, beta, gamma = model.theta, model.beta, model.gamma

    def sdf(x, x_next, xi):
        x, x_next, xi = (torch.as_tensor(a) for a in (x, x_next, xi))
        z = x[zi]
        sigma_c = model.phi_c * torch.exp(x[1])
        g_c = torch.exp(model.mu_c + z + sigma_c * xi)
        w_now = w_star_func(x)
        w_next = w_star_func(x_next)
        return (beta ** theta * torch.exp(theta * x_next[0])
                * g_c ** (-gamma)
                * (w_next / (w_now - 1.0)) ** (theta - 1.0))

    return sdf


def sdf_factory_ssy(model: SSY, w_star_func: Callable) -> Callable:
    """Family-named alias of :func:`sdf_factory`."""
    return sdf_factory(model, w_star_func)


def sdf_factory_gcy(model: GCY, w_star_func: Callable) -> Callable:
    """Family-named alias of :func:`sdf_factory`."""
    return sdf_factory(model, w_star_func)
