"""Solution callables: the interpolated w*(x) of a solved field.

PyTorch port of ``sdfs_via_autodiff_tpu/sdf/wstar.py``: the deliverable
that the SDF computations downstream of a solve consume.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import resolve_device
from ..ops.interp import lin_interp
from ..utils.checkpoint import load_solution

__all__ = ["construct_wstar_callable"]


def construct_wstar_callable(w_star_vals=None,
                             grids: Optional[Sequence] = None,
                             datafile: Optional[str] = None, *,
                             device="cuda"):
    """Return ``x -> w*(x)``, the multilinear interpolant of
    ``w_star_vals`` on ``grids``, evaluated on ``device`` in the field's
    dtype.  ``x`` has shape (dim,) or (dim, N) (a tensor or an array);
    the result is a 0-d or (N,) tensor.

    Pass ``(w_star_vals, grids)``, or ``datafile``: a checkpoint written
    by :func:`..utils.checkpoint.save_solution` of either package, read
    (as in the JAX package) only when the arrays are missing.
    """
    dev = resolve_device(device)
    if w_star_vals is None or grids is None:
        if datafile is None:
            raise ValueError("provide (w_star_vals, grids) or datafile")
        ckpt = load_solution(datafile)
        w_star_vals, grids = ckpt.w_star, ckpt.grids
    w = torch.as_tensor(w_star_vals).to(dev)
    grids = tuple(torch.as_tensor(g).to(device=dev, dtype=w.dtype)
                  for g in grids)

    def w_star_func(x):
        x = torch.as_tensor(x).to(device=dev, dtype=w.dtype)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        out = lin_interp(x, w, grids)
        return out[0] if squeeze else out

    return w_star_func
