"""The solvers on a sharded iterate.

A solve whose start is a DTensor runs its loop on this rank's shard,
through ``T.local``: one of the sharded operators of
``parallel/shard_ops.py``, or the local form of any other operator
(``parallel/gspmd.py``).  Every quantity that the loop's
decisions read (sup-norms, the float64 dot products and norms of the
Krylov solvers, Anderson's Gram matrix, the finiteness checks) is
all-reduced over the ranks that hold distinct shards, so each rank
takes the same steps and stops at the same iteration; the result's
``x`` is a DTensor again.  On one device (:data:`LOCAL`) each reduction
is the plain torch one.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist

from ..ops.dtensor import is_dtensor
from ..parallel.gspmd import local_operator

__all__ = ["Reductions", "LOCAL", "solve_parts", "tangent_matvec"]


class Reductions:
    """Global reductions of a solver loop over an iterate: over the
    process group ``group``, or (None) over one device's tensors."""

    def __init__(self, group=None):
        self.group = group
        self.sharded = group is not None

    def _all(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.sharded:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def sup(self, v: torch.Tensor) -> torch.Tensor:
        """max |v| over the whole field, NaN where any shard holds a NaN
        (a MAX all-reduce need not carry one through: gloo's depends on
        the order of its operands, NCCL's drops it), so that every rank
        sees the NaN the single-device loop would."""
        m = torch.amax(torch.abs(v))
        if not self.sharded:
            return m
        pair = self._all(torch.stack([m, torch.isnan(m).to(m.dtype)]),
                         dist.ReduceOp.MAX)
        return torch.where(pair[1] > 0, math.nan, pair[0])

    def dot64(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """<a, b> accumulated in float64."""
        return self._all(torch.dot(a.to(torch.float64), b.to(torch.float64)),
                         dist.ReduceOp.SUM)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """||v||_2 in v's dtype: the norm of the ranks' local norms (on
        one rank exactly the local norm)."""
        n = torch.linalg.vector_norm(v.reshape(-1))
        if not self.sharded:
            return n
        out = n.new_empty(dist.get_world_size(self.group))
        dist.all_gather_into_tensor(out, n.reshape(1), group=self.group)
        return torch.linalg.vector_norm(out)

    def all_finite(self, v: torch.Tensor) -> torch.Tensor:
        ok = torch.all(torch.isfinite(v))
        if not self.sharded:
            return ok
        return self._all(ok.to(torch.int32), dist.ReduceOp.MIN).bool()

    def numel(self, v: torch.Tensor) -> int:
        """The element count of the whole field."""
        if not self.sharded:
            return v.numel()
        n = torch.tensor(v.numel(), dtype=torch.int64, device=v.device)
        return int(self._all(n, dist.ReduceOp.SUM))

    def gram(self, G: torch.Tensor) -> torch.Tensor:
        """G G^T of the flattened histories (rows of G)."""
        return self._all(G @ G.T, dist.ReduceOp.SUM)


LOCAL = Reductions()


def solve_parts(T: Callable, x0):
    """(operator, linearization, start, reductions, wrap, numel) of a
    solve.  For a DTensor start: ``T.local``, ``T.local_twin``, this
    rank's shard of ``x0``, the :class:`Reductions` of T's shard group, a
    function wrapping a shard back into a DTensor and the global element
    count, where ``T`` is one of the sharded operators of
    ``parallel.shard_ops`` or else the local form of any operator at
    ``x0`` (``parallel.gspmd.local_operator``: the single-device
    operators run on the DTensor, reduced over the ranks holding distinct
    shards, and linearized by the derivative of a VJP).  Otherwise
    ``T``, ``T.twin`` (or ``T``), ``x0``, :data:`LOCAL`, the identity and
    ``x0.numel()``."""
    if is_dtensor(x0):
        if not hasattr(T, "local"):
            T = local_operator(T, x0)
        return (T.local, T.local_twin, T.to_local(x0),
                Reductions(T.reduce_axis.group), T.from_local, x0.numel())
    return T, getattr(T, "twin", T), x0, LOCAL, (lambda x: x), x0.numel()


def tangent_matvec(lin: Callable, x) -> Callable:
    """Newton's ``v -> J(x) v - v`` of ``lin``: its own ``linearize(x)``
    where it has one (the LSE-chain operators' hand tangent-linear,
    ``ops/tangent.py``, built once per call; the derivative of a VJP for a
    DTensor iterate's local form without one,
    ``parallel.gspmd.VjpLinearization``), else ``torch.func.jvp`` per
    matvec."""
    if hasattr(lin, "linearize"):
        return lin.linearize(x)
    return lambda v: torch.func.jvp(lambda y: lin(y) - y, (x,), (v,))[1]
