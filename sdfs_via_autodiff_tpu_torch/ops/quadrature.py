"""Gauss–Hermite quadrature for standard-normal expectations.

Replaces ``quantecon.quad.qnwnorm`` used by the reference continuous layer
(reference ``code/ssy/continuous_junnan/ssy_wc_ratio_continuous.py:254``,
``code/gcy/continuous/gcy_wc_ratio_continuous.py``).  Built from NumPy's
probabilists' Hermite rules on host; nodes/weights are exact for N(0, 1).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["gauss_hermite_normal", "tensor_quadrature_normal"]


def gauss_hermite_normal(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Hermite rule for E[f(X)], X ~ N(0, 1).

    Returns (nodes, weights) with weights summing to 1.
    """
    # hermegauss targets weight exp(-x^2/2); normalize by sqrt(2*pi).
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / np.sqrt(2.0 * np.pi)


def tensor_quadrature_normal(n_per_dim: Sequence[int]
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Tensor-product rule for a dim-dimensional standard normal.

    Returns ``(nodes, weights)`` with ``nodes`` of shape (dim, N) — the
    layout the continuous operators consume (reference transposes qnwnorm's
    output at ``ssy_wc_ratio_continuous.py:255``) — and ``weights`` of shape
    (N,) summing to 1, where N = prod(n_per_dim).  First dimension varies
    slowest ('ij' meshgrid order).
    """
    rules = [gauss_hermite_normal(n) for n in n_per_dim]
    node_grids = np.meshgrid(*[r[0] for r in rules], indexing="ij")
    nodes = np.stack([g.ravel() for g in node_grids], axis=0)
    weights = rules[0][1]
    for _, w in rules[1:]:
        weights = np.multiply.outer(weights, w)
    return nodes, weights.ravel()
