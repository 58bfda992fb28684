"""Solver result structure (port of ``solvers/result.py``).

Every solver returns a :class:`SolveResult` carrying the solution, the
iteration count, the final residual and a convergence flag.  The loop
has synchronised with the host by the time it returns, so the scalars
are plain Python numbers; the iterate stays on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class SolveResult:
    """Outcome of a fixed-point solve.

    Attributes
    ----------
    x:          the final iterate (a tensor on the solve's device)
    iterations: number of operator applications of the *outer* loop
    residual:   final sup-norm error
    converged:  residual <= tol and no NaN/divergence guard tripped
    error_trace: the per-iteration residual history (a fixed-length
        tensor padded with NaN) when ``trace_len`` asked for one, else
        None

    ``drivers.wc_ratio_sweep`` returns one with a leading sweep axis on
    every field (``x`` stacked; the others as CPU tensors).
    """

    x: torch.Tensor
    iterations: int
    residual: float
    converged: bool
    error_trace: Optional[torch.Tensor] = None

    def __repr__(self) -> str:
        if isinstance(self.residual, torch.Tensor):
            # A sweep's result: one entry per member.
            return (f"SolveResult(iterations={self.iterations.tolist()}, "
                    f"residual={[f'{r:.3e}' for r in self.residual.tolist()]}"
                    f", converged={self.converged.tolist()})")
        return (f"SolveResult(iterations={self.iterations}, "
                f"residual={self.residual:.3e}, "
                f"converged={self.converged})")
