"""Schorfheide, Song and Yaron (2018) as a per-axis chain (:mod:`.chain`).

State (h_lam, h_c, h_z, z); z' = rho z + phi_z exp(h_z) e, its grid
scaled by the current h_z.  Every AR(1) is discretized by
:mod:`.tauchen`.  Consumption growth g' = mu_c + z + sigma_c xi,
sigma_c = phi_c exp(h_c), so a current state tilts the expectation by
0.5 ((1 - gamma) sigma_c)^2 + (1 - gamma)(mu_c + z); the next preference
state enters as exp(theta h_lam').
"""

from __future__ import annotations

import torch

from . import tauchen
from .chain import KoopmansChain, theta_of

__all__ = ["build"]


def build(p: dict, shape, *, device, precision) -> KoopmansChain:
    """The chain at parameters ``p`` (by the model's names) on a grid of
    ``shape``."""
    n_l, n_k, n_i, n_j = shape
    g = 1.0 - p["gamma"]
    h_lam, P_lam = tauchen.chain(n_l, p["rho_lam"], p["s_lam"])
    h_c, P_c = tauchen.chain(n_k, p["rho_c"], p["s_c"])
    h_z, P_hz = tauchen.chain(n_i, p["rho_z"], p["s_z"])
    P_z = tauchen.transition(n_j, p["rho"])
    sigma_c = p["phi_c"] * torch.exp(h_c)
    z = (p["phi_z"] * torch.exp(h_z))[:, None] * tauchen.unit_grid(
        n_j, p["rho"])[None, :]
    tilt = (0.5 * (g * sigma_c) ** 2)[None, :, None, None] \
        + (g * (p["mu_c"] + z))[None, None, :, :]
    return KoopmansChain(shape, ((0, P_lam), (1, P_c), (2, P_hz), (3, P_z)),
                         (0, h_lam), tilt, theta_of(p), p["beta"],
                         device=device, precision=precision)
