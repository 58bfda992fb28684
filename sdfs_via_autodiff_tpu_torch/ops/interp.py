"""Multilinear interpolation on uniform tensor-product grids.

PyTorch port of ``sdfs_via_autodiff_tpu/ops/interp.py``: a corner-gather
interpolant.  Out-of-range query points clamp to the grid edges (the
'nearest' boundary rule of ``map_coordinates(order=1, mode='nearest')``),
interior points get the standard 2^d-corner convex combination.  Plain
tensor indexing, so it runs on any device and differentiates.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

__all__ = ["uniform_grid_coords", "multilinear_interp", "lin_interp"]


def uniform_grid_coords(grids: Sequence[torch.Tensor],
                        x: torch.Tensor) -> torch.Tensor:
    """Affine map from state values to fractional grid coordinates.

    ``x`` has shape (dim, ...); grid d contributes coordinate
    ``(x[d] - grid[0]) / (grid[1] - grid[0])``.  Assumes uniform grids.
    A size-1 (collapsed) grid has no step: its coordinate is
    ``x[d] - grid[0]``, which :func:`multilinear_interp` then clamps.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    steps = torch.stack([g[1] - g[0] if g.shape[0] > 1 else one
                         for g in grids])
    lows = torch.stack([g[0] for g in grids])
    bshape = (len(grids),) + (1,) * (x.ndim - 1)
    return (x - lows.reshape(bshape)) / steps.reshape(bshape)


def multilinear_interp(values: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Interpolate ``values`` (shape ``grid_shape``) at fractional
    ``coords`` (shape ``(dim, N)``); returns shape ``(N,)``.

    Edge handling clamps coordinates into the valid cell range.
    """
    dim = values.ndim
    if coords.shape[0] != dim:
        raise ValueError(f"coords leading axis {coords.shape[0]} != values "
                         f"ndim {dim}")
    lo_idx, frac = [], []
    for d in range(dim):
        n = values.shape[d]
        c = coords[d]
        if n == 1:
            lo_idx.append(torch.zeros_like(c, dtype=torch.int64))
            frac.append(torch.zeros_like(c))
            continue
        i0 = torch.clamp(torch.floor(c), 0, n - 2).to(torch.int64)
        lo_idx.append(i0)
        frac.append(torch.clamp(c - i0, 0.0, 1.0))

    out = None
    for corner in itertools.product((0, 1), repeat=dim):
        idx = tuple(lo_idx[d] + corner[d] if values.shape[d] > 1
                    else lo_idx[d] for d in range(dim))
        wgt = None
        for d in range(dim):
            f = frac[d] if corner[d] else 1.0 - frac[d]
            wgt = f if wgt is None else wgt * f
        term = values[idx] * wgt
        out = term if out is None else out + term
    return out


def lin_interp(x: torch.Tensor, fun_vals: torch.Tensor,
               grids: Sequence[torch.Tensor]) -> torch.Tensor:
    """``fun_vals`` on ``grids`` interpolated at ``x`` (shape (dim, N) in
    state units)."""
    return multilinear_interp(fun_vals, uniform_grid_coords(grids, x))
