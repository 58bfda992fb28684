"""Gomez-Cram and Yaron (2021) as a per-axis chain (:mod:`.chain`).

State (z, z_pi, h_z, h_c, h_zpi, h_lam); z_pi' = rho_pipi z_pi +
phi_zpi exp(h_zpi) e and z' = rho z + rho_pi z_pi + phi_z exp(h_z) e,
each grid scaled by its current volatility and z's centred at
rho_pi z_pi / (1 - rho).  Every AR(1) is discretized by :mod:`.tauchen`;
the tilt and the preference state enter as in :mod:`.ssy`.
"""

from __future__ import annotations

import torch

from . import tauchen
from .chain import KoopmansChain, theta_of

__all__ = ["build"]


def build(p: dict, shape, *, device, precision) -> KoopmansChain:
    """The chain at parameters ``p`` (by the model's names) on a grid of
    ``shape``."""
    n_a, n_b, n_c, n_d, n_e, n_l = shape
    g = 1.0 - p["gamma"]
    h_z, P_hz = tauchen.chain(n_c, p["rho_z"], p["s_z"])
    h_c, P_c = tauchen.chain(n_d, p["rho_c"], p["s_c"])
    h_zpi, P_hzpi = tauchen.chain(n_e, p["rho_zpi"], p["s_zpi"])
    h_lam, P_lam = tauchen.chain(n_l, p["rho_lam"], p["s_lam"])
    P_zpi = tauchen.transition(n_b, p["rho_pipi"])
    P_z = tauchen.transition(n_a, p["rho"])
    sigma_c = p["phi_c"] * torch.exp(h_c)
    z_pi = (p["phi_zpi"] * torch.exp(h_zpi))[:, None] * tauchen.unit_grid(
        n_b, p["rho_pipi"])[None, :]                         # (e, b)
    centre = p["rho_pi"] / (1.0 - p["rho"]) * z_pi           # (e, b)
    spread = (p["phi_z"] * torch.exp(h_z))[:, None] * tauchen.unit_grid(
        n_a, p["rho"])[None, :]                              # (c, a)
    z = (centre.T[None, :, None, :]
         + spread.T[:, None, :, None])                       # (a, b, c, e)
    tilt = ((g * (p["mu_c"] + z))[:, :, :, None, :, None]
            + (0.5 * (g * sigma_c) ** 2)[None, None, None, :, None, None])
    axes = ((5, P_lam), (3, P_c), (2, P_hz), (4, P_hzpi), (1, P_zpi),
            (0, P_z))
    return KoopmansChain(shape, axes, (5, h_lam), tilt, theta_of(p),
                         p["beta"], device=device, precision=precision)
