"""The solvers on a DTensor iterate with a single-device operator.

The operators themselves take a DTensor through
``ops/dtensor.transparent`` (constants lifted to ``Replicate()``, the
result on the input's placements).  This module gives the solvers what
they need on top of that:

* :func:`local_operator`: the local form of any operator at a DTensor
  start (this rank's shard -> DTensor -> T -> shard), as a
  :class:`~.shard_ops.ShardedOperator` whose reductions span only the
  ranks that hold distinct shards.
* The tangent: an operator with a hand linearization (``T.linearize``,
  ``ops/tangent.py``) that takes a DTensor (``ops/dtensor.transparent``)
  runs it on the DTensor, plain ops that DTensor dispatches
  (:class:`_LocalLinearization`).  Forward-mode AD does not
  run on a DTensor (torch 2.11-2.13), so for any other operator it is the
  derivative of a VJP (:class:`VjpLinearization`, :func:`jvp_by_vjp`):
  per linearization point one primal and one backward with its graph
  kept, then one double-backward pass per matvec.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.dtensor import apply, from_local, is_dtensor, to_local
from .shard_ops import ShardedOperator, _Axis, _axis

__all__ = ["local_operator", "VjpLinearization", "jvp_by_vjp"]


# ------------------------------------------------------ the tangent route

class VjpLinearization:
    """A local operator whose tangent is the derivative of its VJP:
    :meth:`linearize` at x runs the primal and a backward that keeps its
    graph, g(u) = J^T u at u = 0, and each matvec is one backward of g:
    d<g(u), v>/du = J v.  Forward-mode AD refuses DTensors; this route
    runs every op in reverse mode only."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)

    def linearize(self, x) -> Callable:
        """``v -> J(x) v - v`` (Newton's ``(J - I) v``), built on the
        first matvec: a frozen Newton step that makes none costs
        nothing."""
        state = {}

        def matvec(v):
            if not state:
                with torch.enable_grad():
                    xg = x.detach().requires_grad_(True)
                    y = self.fn(xg)
                    u = torch.zeros_like(y, requires_grad=True)
                    (g,) = torch.autograd.grad(y, xg, u, create_graph=True)
                state.update(g=g, u=u)
            (jv,) = torch.autograd.grad(state["g"], state["u"], v,
                                        retain_graph=True)
            return jv - v
        return matvec


class _LocalLinearization:
    """The local form of an operator with a hand linearization: its
    tangent tape built and replayed on the DTensor (this rank's shard in,
    its shard out), one build per linearization point."""

    def __init__(self, fn: Callable, linearize: Callable, spec: tuple):
        self.fn = fn
        self._linearize = linearize
        self._spec = spec                # mesh, placements, shape, stride

    def __call__(self, x):
        return self.fn(x)

    def linearize(self, x) -> Callable:
        lin = self._linearize(from_local(x, *self._spec))
        return lambda v: to_local(lin(from_local(v, *self._spec)))


def jvp_by_vjp(fn: Callable, primals: tuple, tangents: tuple):
    """``fn``'s tangent at ``primals`` along ``tangents`` as the
    derivative of its VJP (one primal, one backward with its graph and
    one double backward): the forward-mode product on DTensors."""
    with torch.enable_grad():
        xs = tuple(p.detach().requires_grad_(True) for p in primals)
        y = fn(*xs)
        u = torch.zeros_like(y, requires_grad=True)
        gs = torch.autograd.grad(y, xs, u, create_graph=True)
        (jv,) = torch.autograd.grad(gs, u, tangents)
    return jv


# ------------------------------------------------- the solvers' local form

def _distinct_axis(mesh, placements):
    """The :class:`~.shard_ops._Axis` of the mesh axes that shard the
    field (the ranks holding distinct shards), or one of size 1 when the
    field is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    for p in placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"a solver iterate must be sharded or "
                             f"replicated, not {p}")
    names = mesh.mesh_dim_names
    dims = [d for d, p in enumerate(placements) if isinstance(p, Shard)]
    if not dims:
        return _Axis(None, 1, 0)
    if names is None:
        raise ValueError("name the mesh's axes (parallel.make_mesh does)")
    return _axis(mesh, tuple(names[d] for d in dims))


def local_operator(T: Callable, x0):
    """The local form of ``T`` at the DTensor start ``x0``: a
    :class:`~.shard_ops.ShardedOperator` with ``x0``'s mesh and
    placements whose ``local`` maps this rank's shard to its shard of
    ``T``'s result, ``local_twin`` the same for ``T.twin`` (or ``T``),
    linearized by its own ``linearize`` on the DTensor where it has one
    and takes a DTensor (``ops/dtensor.transparent``:
    :class:`_LocalLinearization`), else a :class:`VjpLinearization`
    (the node chains and the gather, whose linearization is
    single-device),
    and ``reduce_axis`` the ranks holding distinct shards."""
    mesh, placements = x0.device_mesh, tuple(x0.placements)
    shape, stride = tuple(x0.shape), x0.stride()

    def local_of(fn):
        def local(x):
            y = apply(fn, from_local(x, mesh, placements, shape, stride))
            if not is_dtensor(y):
                raise ValueError("an operator applied to a DTensor must "
                                 "return one")
            return to_local(y)
        return local

    twin = getattr(T, "twin", T)
    if hasattr(twin, "linearize") and getattr(twin, "takes_dtensor", False):
        local_twin = _LocalLinearization(local_of(twin), twin.linearize,
                                         (mesh, placements, shape, stride))
    else:
        local_twin = VjpLinearization(local_of(twin))
    return ShardedOperator(
        local_of(T), mesh, placements, shape, _distinct_axis(mesh,
                                                             placements),
        local_twin=local_twin)
