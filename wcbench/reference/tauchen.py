"""Tauchen (1986) discretization of a Gaussian AR(1), y' = rho y + s e.

The grid spans ``m`` unconditional standard deviations in equal steps;
the transition probabilities are normal-CDF masses of the cells between
midpoints, the two end cells taking the tails.  On the unit grid (s = 1)
the matrix depends on (n, rho, m) only; states scale with s.
"""

from __future__ import annotations

import math

import torch

__all__ = ["unit_grid", "transition", "chain"]

M_STD = 3.0


def unit_grid(n: int, rho: float, m: float = M_STD) -> torch.Tensor:
    """The n grid points for s = 1 (float64, host)."""
    if n == 1:
        return torch.zeros(1, dtype=torch.float64)
    half = m / math.sqrt(1.0 - rho * rho)
    return torch.linspace(-half, half, n, dtype=torch.float64)


def transition(n: int, rho: float, m: float = M_STD) -> torch.Tensor:
    """(n, n) matrix P[i, j] = Prob(y' in cell j | y = y_i)."""
    if n == 1:
        return torch.ones((1, 1), dtype=torch.float64)
    y = unit_grid(n, rho, m)
    edges = 0.5 * (y[1:] + y[:-1])
    cdf = torch.special.ndtr(edges[None, :] - rho * y[:, None])
    left = torch.cat([torch.zeros(n, 1, dtype=torch.float64), cdf], dim=1)
    right = torch.cat([cdf, torch.ones(n, 1, dtype=torch.float64)], dim=1)
    return right - left


def chain(n: int, rho: float, s: float):
    """(states, P) of y' = rho y + s e on n points."""
    return s * unit_grid(n, rho), transition(n, rho)
