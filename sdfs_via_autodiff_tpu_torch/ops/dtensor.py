"""Eager operators on a DTensor iterate.

In the JAX package any single-device operator applied to a field with a
``NamedSharding`` runs sharded: XLA's partitioner (GSPMD) places the
collectives.  Here the iterate is a :class:`torch.distributed.tensor.
DTensor` and DTensor's sharding propagation places them, op by op.  This
module holds what the operators and kernels need for that, and depends
on nothing above ``ops``:

* :func:`transparent` wraps an eager operator: a plain tensor takes the
  operator's own code (one type check more), a DTensor runs it under
  :class:`_Lift`, which turns every plain tensor that meets a DTensor in
  one op (the operator's matrices, 0-d constants, baselines) into a
  ``Replicate()`` DTensor on the iterate's mesh, and the result is
  redistributed to the input's placements (the counterpart of
  ``with_sharding_constraint``).  A lift is a wrap of the tensor's
  metadata, made anew at each op and held by nothing after it; a tensor
  on an autograd path (a parameter-dependent constant of an implicit
  gradient) is lifted in the graph, so its gradient reaches the
  parameter as a plain tensor.
* :func:`refuse` is the kernel-backed operators' check: a DTensor never
  reaches a hand-written kernel, and is never gathered for one.
* DTensor's own ``from_local``, ``to_local`` (torch 2.11) and
  ``redistribute`` backwards leave autograd, which would cut the graph
  of a derivative of a VJP (``parallel/gspmd.py``'s tangent route), so
  :class:`_FromLocal`, :class:`_ToLocal` and :class:`_Redistribute` give
  backwards that are DTensor's differentiable forward operations.

The solvers' local form of an operator at a DTensor start and the
tangent route are in ``parallel/gspmd.py``.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["is_dtensor", "transparent", "refuse", "apply"]


@functools.lru_cache(maxsize=None)
def _dtensor_type():
    import torch.distributed as dist
    if not dist.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    """True for a DTensor (a plain tensor costs one type comparison)."""
    if type(x) is torch.Tensor:
        return False
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose backward is differentiable: the
    gradient is redistributed to the forward placements, then made local,
    by DTensor's autograd operations (``from_local``'s own backward
    redistributes outside autograd), so that a derivative of a VJP
    reaches through it to the shard or to a lifted parameter."""

    @staticmethod
    def forward(t, mesh, placements, shape, stride):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.placements = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return (g.redistribute(ctx.mesh, ctx.placements).to_local(), None,
                None, None, None)


class _ToLocal(torch.autograd.Function):
    """``DTensor.to_local`` whose backward is :class:`_FromLocal` (torch
    2.11's own wraps the gradient in a DTensor outside autograd, which
    cuts a derivative of a VJP off at the local form's output)."""

    @staticmethod
    def forward(d):
        return d.to_local()

    @staticmethod
    def setup_context(ctx, inputs, output):
        d = inputs[0]
        ctx.spec = (d.device_mesh, tuple(d.placements), d.shape, d.stride())

    @staticmethod
    def backward(ctx, g):
        return from_local(g, *ctx.spec)


class _Redistribute(torch.autograd.Function):
    """``DTensor.redistribute`` whose backward redistributes the gradient
    back by DTensor's autograd operation (so that it is differentiable
    on every torch version the port runs)."""

    @staticmethod
    def forward(d, mesh, placements):
        return d.redistribute(mesh, placements)

    @staticmethod
    def setup_context(ctx, inputs, output):
        d = inputs[0]
        ctx.spec = (d.device_mesh, tuple(d.placements))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.spec), None, None


def from_local(t, mesh, placements, shape=None, stride=None):
    """``DTensor.from_local`` (no check, no communication) with a
    differentiable backward (:class:`_FromLocal`)."""
    shape = torch.Size(t.shape if shape is None else shape)
    stride = t.stride() if stride is None else tuple(stride)
    return _FromLocal.apply(t, mesh, tuple(placements), shape, stride)


def to_local(d):
    """``d.to_local()`` with a differentiable backward (:class:`_ToLocal`)."""
    return _ToLocal.apply(d)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _lift(t: torch.Tensor, mesh):
    """``t`` as a ``Replicate()`` DTensor on ``mesh``: a wrap of its
    metadata (a 0-d CPU tensor, a parameter, that meets a CUDA field as
    on one device first moves to the mesh's device)."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = (Replicate(),) * mesh.ndim
    local = t if t.device.type == mesh.device_type else t.to(
        _mesh_device(mesh))
    if (t.requires_grad
            or torch._C._functorch.is_functorch_wrapped_tensor(t)):
        return from_local(local, mesh, rep)
    return DTensor.from_local(local, mesh, rep, run_check=False)


class _Lift(TorchFunctionMode):
    """Plain tensors meeting a DTensor in one torch call become
    ``Replicate()`` on its mesh (:func:`_lift`).  The arguments are
    scanned one level deep (tensors, and lists or tuples of them, such
    as ``torch.stack``'s): every call inside DTensor's own dispatch
    passes through here too, so the scan stays cheap."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        DTensor = _dtensor_type()
        mesh = None
        for a in (*args, *kwargs.values()):
            if isinstance(a, DTensor):
                mesh = a.device_mesh
                break
            if isinstance(a, (list, tuple)):
                mesh = next((b.device_mesh for b in a
                             if isinstance(b, DTensor)), None)
                if mesh is not None:
                    break
        if mesh is None:
            return func(*args, **kwargs)

        def lift(a):
            if isinstance(a, torch.Tensor):
                return a if isinstance(a, DTensor) else _lift(a, mesh)
            if isinstance(a, (list, tuple)):
                return type(a)(lift(b) for b in a)
            return a
        args, kwargs = tuple(map(lift, args)), {k: lift(v) for k, v
                                               in kwargs.items()}
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "Sharding propagation failed" not in str(e):
                raise
        return _replicated_call(func, args, kwargs)


def _replicated_call(func, args, kwargs):
    """``func`` on replicated copies of its DTensor arguments, for an op
    whose sharding DTensor cannot propagate (torch 2.11 refuses, e.g., an
    einsum that flattens two sharded grid axes), as XLA would gather
    them; a result of a sharded argument's shape goes back to that
    argument's placements.  The gather is announced by a
    ``RuntimeWarning`` naming the op and the placements it gathered
    (once for each, by the warnings module's default filter)."""
    from torch.distributed.tensor import DTensor, Replicate
    sharded = []

    def gather(a):
        if isinstance(a, DTensor):
            rep = (Replicate(),) * a.device_mesh.ndim
            if tuple(a.placements) == rep:
                return a
            sharded.append(a)
            return _Redistribute.apply(a, a.device_mesh, rep)
        if isinstance(a, (list, tuple)):
            return type(a)(gather(b) for b in a)
        return a
    args = tuple(map(gather, args))
    kwargs = {k: gather(v) for k, v in kwargs.items()}
    warnings.warn(
        f"DTensor cannot shard {getattr(func, '__name__', func)} on "
        f"{[tuple(a.placements) for a in sharded]}: it runs on a full "
        "copy of each sharded argument on every rank", RuntimeWarning,
        stacklevel=2)
    out = func(*args, **kwargs)
    like = next((a for a in sharded if isinstance(out, DTensor)
                 and a.shape == out.shape), None)
    if like is not None:
        out = _Redistribute.apply(out, like.device_mesh,
                                  tuple(like.placements))
    return out


def _lifting() -> bool:
    from torch.overrides import _get_current_function_mode_stack
    return any(isinstance(m, _Lift)
               for m in _get_current_function_mode_stack())


def _placed(y, x):
    """``y`` with ``x``'s mesh and placements where it is a field of
    ``x``'s shape (the sharding the operator's output keeps)."""
    if (is_dtensor(y) and y.shape == x.shape
            and (y.device_mesh != x.device_mesh
                 or tuple(y.placements) != tuple(x.placements))):
        y = _Redistribute.apply(y, x.device_mesh, tuple(x.placements))
    return y


def apply(fn: Callable, x):
    """``fn(x)`` for a DTensor ``x``: plain constants lifted to
    ``Replicate()``, the result on ``x``'s placements."""
    if _lifting():
        return _placed(fn(x), x)
    with _Lift():
        return _placed(fn(x), x)


def transparent(fn: Callable) -> Callable:
    """``fn`` taking a DTensor as well as a plain tensor (see the module
    docstring); a plain tensor runs ``fn`` itself.  ``T.takes_dtensor``
    marks it."""
    @functools.wraps(fn)
    def T(x):
        return apply(fn, x) if is_dtensor(x) else fn(x)
    T.takes_dtensor = True
    return T


def refuse(x, what: str) -> None:
    """Raise ``ValueError`` when ``x`` is a DTensor: ``what`` launches
    hand-written kernels on one device's plain tensors."""
    if is_dtensor(x):
        raise ValueError(
            f"{what} launches hand-written kernels on one device and takes "
            "a plain tensor, not a DTensor; shard the operand set with "
            "parallel.streamed_shard_map_factory, or apply T.twin (the "
            "eager operator, which takes a DTensor)")
