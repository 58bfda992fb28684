"""The Koopmans operator of a discrete model as a chain of per-axis
contractions, in log space.

On a tensor grid whose axes move independently given the current state,

    T(l) = log(1 + beta * exp(h / theta)),
    h    = tilt + log sum_{x'} P(x -> x') exp(theta * (l(x') + pre(x'))),

with P the product of one transition matrix per axis, ``tilt`` a field
of the current state and ``pre`` a term of one next-state axis.  Each
contraction is y = m + log(W exp(a - m)), m the maximum over the
contracted axis, so no intermediate leaves the exponent range.

The tangent of one contraction is W (E * da) / D, E = exp(a - m) and
D = W E (m cancels); :meth:`KoopmansChain.linearize` keeps E and D of
each stage and replays them per matvec.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["PRECISIONS", "KoopmansChain", "to_tf32", "theta_of"]

PRECISIONS = ("float64", "tf32")


def theta_of(p: dict) -> float:
    """The Epstein-Zin exponent (1 - gamma) / (1 - 1/psi)."""
    return (1.0 - p["gamma"]) / (1.0 - 1.0 / p["psi"])


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits, round to
    nearest on the magnitude), as the tensor cores read an operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class KoopmansChain:
    """T on a grid of ``shape`` from ``axes`` = ((axis, P), ...), the
    next-state term ``pre`` = (axis, vector) and the current-state
    ``tilt`` (broadcastable to ``shape``), all float64 on the host.

    ``precision`` "float64" computes in float64; "tf32" computes in
    float32 and rounds both operands of every product of the operator to
    TF32, with float32 accumulation (TF32 off in the library, so the
    products are exact and only the rounding of the operands differs
    from FP32).  The tangent stays FP32-accurate in both: with TF32
    products its relative error (~7e-4) is the size of 1 - rho, the
    smallest eigenvalue of I - J, and Newton's Krylov solve stagnates.
    """

    def __init__(self, shape: Sequence[int], axes, pre: Tuple[int, object],
                 tilt, theta: float, beta: float, *, device,
                 precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.shape = tuple(int(n) for n in shape)
        self.theta, self.beta = float(theta), float(beta)
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self._tf32 = precision == "tf32"
        cast = lambda a: torch.as_tensor(a, dtype=torch.float64).to(
            device=device, dtype=self.dtype)
        self.axes = [(int(ax), cast(P)) for ax, P in axes]
        ax, vec = pre
        view = [1] * len(self.shape)
        view[ax] = -1
        self.pre = self.theta * cast(vec).reshape(view)
        self.tilt = cast(tilt)

    def _contract(self, a, axis: int, P):
        m = torch.amax(a, dim=axis, keepdim=True)
        E = torch.exp(a - m)
        if self._tf32:
            D = torch.tensordot(to_tf32(E), to_tf32(P), dims=([axis], [1]))
        else:
            D = torch.tensordot(E, P, dims=([axis], [1]))
        D = torch.movedim(D, -1, axis)
        return m + torch.log(D), E, D

    def _apply(self, ell, keep: bool):
        a = self.theta * ell.to(self.dtype) + self.pre
        stages = []
        for axis, P in self.axes:
            a, E, D = self._contract(a, axis, P)
            if keep:
                stages.append((axis, P, E, D))
        u = self.beta * torch.exp((a + self.tilt) / self.theta)
        out = torch.log1p(u)
        return out, stages, u / (1.0 + u)

    def __call__(self, ell: torch.Tensor) -> torch.Tensor:
        """log T(exp(ell)) in the chain's dtype."""
        return self._apply(ell, keep=False)[0]

    def linearize(self, ell: torch.Tensor) -> Tuple[torch.Tensor, Callable]:
        """(T(ell), v -> J(ell) v), J the derivative of T at ell."""
        out, stages, s = self._apply(ell, keep=True)

        def jvp(v):
            da = v.to(self.dtype)
            for axis, P, E, D in stages:
                da = torch.tensordot(E * da, P, dims=([axis], [1]))
                da = torch.movedim(da, -1, axis) / D
            return s * da
        return out, jvp
