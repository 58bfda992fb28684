"""Uniform state-space grids for the continuous-state operators.

PyTorch port of ``sdfs_via_autodiff_tpu/ops/grids.py``.  h-process grids
span ``±num_std_devs`` stationary standard deviations centred at zero;
the z grids account for stochastic volatility by using the *maximum*
volatility state.  Grids are uniform so interpolation coordinates stay
affine.

Every grid is built in float64 with ``jnp.linspace``'s formula,
start * (1 - i/(n-1)) + stop * i/(n-1) with the end point set to stop,
and then cast to ``dtype``.  A float64 grid agrees with the JAX
package's to a few ulp (XLA's compiled linspace reassociates and fuses
the products, so single points round apart); a float32 grid is the
rounded float64 one, where the JAX package computes its float32 grids in
float32 and may land one float32 ulp apart.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..models.gcy import GCY
from ..models.ssy import SSY

__all__ = ["build_grid_ssy", "build_grid_gcy", "flatten_mesh"]


def _linspace(start: float, stop: float, size: int,
              dtype: torch.dtype) -> torch.Tensor:
    if size == 1:
        out = np.array([start], np.float64)
    else:
        step = np.arange(size - 1, dtype=np.float64) / float(size - 1)
        out = np.concatenate([start * (1.0 - step) + stop * step, [stop]])
    return torch.as_tensor(out).to(dtype)


def _ar1_grid(s: float, rho: float, size: int, num_std: float,
              dtype: torch.dtype) -> torch.Tensor:
    std = math.sqrt(s**2 / (1 - rho**2))
    g = num_std * std
    return _linspace(-g, g, size, dtype)


def build_grid_ssy(model: SSY,
                   h_lam_grid_size: int,
                   h_c_grid_size: int,
                   h_z_grid_size: int,
                   z_grid_size: int,
                   num_std_devs: float = 3.2,
                   dtype: torch.dtype = torch.float64,
                   ) -> Tuple[torch.Tensor, ...]:
    """Grids (h_lam, h_c, h_z, z) for SSY continuous interpolation.

    z spans ``±num_std_devs * sigma_z_max`` where ``sigma_z_max`` uses the
    maximal h_z grid point.
    """
    m = model
    h_lam_grid = _ar1_grid(m.s_lam, m.rho_lam, h_lam_grid_size, num_std_devs, dtype)
    h_c_grid = _ar1_grid(m.s_c, m.rho_c, h_c_grid_size, num_std_devs, dtype)
    h_z_grid = _ar1_grid(m.s_z, m.rho_z, h_z_grid_size, num_std_devs, dtype)

    h_z_max = num_std_devs * math.sqrt(m.s_z**2 / (1 - m.rho_z**2))
    sigma_z_max = m.phi_z * math.exp(h_z_max)
    z_max = num_std_devs * sigma_z_max
    z_grid = _linspace(-z_max, z_max, z_grid_size, dtype)
    return h_lam_grid, h_c_grid, h_z_grid, z_grid


def build_grid_gcy(model: GCY,
                   h_lam_grid_size: int,
                   h_c_grid_size: int,
                   h_z_grid_size: int,
                   h_zpi_grid_size: int,
                   z_grid_size: int,
                   z_pi_grid_size: int,
                   num_std_devs: float = 3.2,
                   dtype: torch.dtype = torch.float64,
                   ) -> Tuple[torch.Tensor, ...]:
    """Grids (h_lam, h_c, h_z, h_zpi, z, z_pi) for GCY continuous
    interpolation; the z bounds fold in the rho_pi * z_pi feedback."""
    m = model
    h_lam_grid = _ar1_grid(m.s_lam, m.rho_lam, h_lam_grid_size, num_std_devs, dtype)
    h_c_grid = _ar1_grid(m.s_c, m.rho_c, h_c_grid_size, num_std_devs, dtype)
    h_z_grid = _ar1_grid(m.s_z, m.rho_z, h_z_grid_size, num_std_devs, dtype)
    h_zpi_grid = _ar1_grid(m.s_zpi, m.rho_zpi, h_zpi_grid_size, num_std_devs, dtype)

    h_zpi_max = num_std_devs * math.sqrt(m.s_zpi**2 / (1 - m.rho_zpi**2))
    sigma_zpi_max = m.phi_zpi * math.exp(h_zpi_max)
    zpi_max = num_std_devs * math.sqrt(sigma_zpi_max**2 / (1 - m.rho_pipi**2))
    z_pi_grid = _linspace(-zpi_max, zpi_max, z_pi_grid_size, dtype)

    h_z_max = num_std_devs * math.sqrt(m.s_z**2 / (1 - m.rho_z**2))
    sigma_z_max = m.phi_z * math.exp(h_z_max)
    z_hi = (m.rho_pi * float(z_pi_grid[-1]) + num_std_devs * sigma_z_max) / (1 - m.rho)
    z_lo = (m.rho_pi * float(z_pi_grid[0]) - num_std_devs * sigma_z_max) / (1 - m.rho)
    z_grid = _linspace(z_lo, z_hi, z_grid_size, dtype)
    return h_lam_grid, h_c_grid, h_z_grid, h_zpi_grid, z_grid, z_pi_grid


def flatten_mesh(grids: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cartesian product of 1-D grids as a (N, dim) tensor in 'ij' order.

    The row for multi-index (i1, ..., id) sits at the flattened C-order
    position, so ``values.reshape(shape)`` inverts the flattening.
    """
    mesh = torch.meshgrid(*grids, indexing="ij")
    return torch.stack([g.reshape(-1) for g in mesh], dim=1)
