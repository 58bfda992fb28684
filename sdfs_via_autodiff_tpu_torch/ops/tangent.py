"""Newton's tangent-linear of the log-sum-exp chains, built once per step.

The JAX package's Newton solver calls ``jax.linearize`` once per Newton
step: the primal chain runs once at the linearization point, its
intermediates are kept, and every Krylov matvec is the pure tangent-linear
chain.  ``torch.func.linearize`` traces the chain on every step, a host
cost larger than the primal it saves, so the port writes the
tangent-linear by hand: each operator's primal takes an optional
:class:`Tape` and says, stage by stage, what its tangent is.

Each contraction stage is ``y = m + log(W e^{a - m})``.  With
``E = e^{a - m}`` and ``D = W E`` its tangent is

    dy = W (E * da) / D,

exact: the shift's tangent cancels between ``m`` and ``log``, so ties in
the maximum do not matter.  The constants of the chain (baseline folds,
``mid_col``, log kappa, row-normalization logs) carry no tangent, a
scale by theta is a factor, and the epilogue ``log1p(q)``, ``q = beta
e^{h/theta}``, has the factor ``q / ((1 + q) theta)``.  A matvec is then
the stages' contractions with one elementwise product between each two:
the tape multiplies every run of factors into one stored tensor (``1/D``
of a stage times the next stage's ``E``), so a chain of n contractions
keeps n + 1 field-sized factors and its matvec runs no exp, log or max.

Where the primal sums several paths, the tape records one step for the
sum, :meth:`Tape.branches`:

    dy = sum_b post_b * L_b(pre_b * dx),

each branch a linear map between two factors (``None`` for 1).  The
factor pending on the tape multiplies into each ``pre_b``; where no
branch has a ``pre`` it is stored once, as a factor before the sum.  A
map ``out`` may follow each branch's product (a sum over a batch axis,
say) before the branches are added.  Two users: the float32 deep
windows of ``ops/contract.py`` (branch k: ``pre`` the window's
exponentials, ``post`` one over its contraction where it is the
shallowest normal window, else 0) and the node chains of
``operators/post_interp.py`` (a branch per node chunk: the chunk's
chain of contractions, ``post`` the folded (chunk, N) factor).

A step may also be an object that holds its own factors (``factors()``)
and may subtract ``v`` itself (``minus_identity``): the two-phase
operators' whole chain as one step (``kernels/tangent_two_phase.py``),
which :class:`Linearization` asks for ``J v - v`` where it is the tape's
only step.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.profiling import spanned
from .dtensor import apply, is_dtensor, transparent

__all__ = ["Tape", "Linearization", "linearizable", "lse_step",
           "log1p_epilogue", "viewed", "replay"]


class _Branches:
    """The linear map ``v -> sum_b out(post_b * fn_b(pre_b * v))``."""

    def __init__(self, terms, out):
        self.terms, self.out = terms, out

    def __call__(self, v):
        acc = None
        for pre, fn, post in self.terms:
            t = fn(v if pre is None else v * pre)
            if post is not None:
                t = t * post
            if self.out is not None:
                t = self.out(t)
            acc = t if acc is None else acc + t
        return acc

    def factors(self):
        for pre, _, post in self.terms:
            yield from (f for f in (pre, post) if f is not None)


class Tape:
    """The tangent-linear of a chain, written down while its primal runs.

    Steps, in the primal's order: :meth:`scale` (an elementwise factor:
    a float, a 0-d tensor or a field), :meth:`linear` (a linear map of the
    field, such as a contraction), :meth:`view` (a reshape, permute or
    cast, which commutes with the factors), :meth:`lse` (a contraction
    stage) and :meth:`branches` (a sum of factored linear maps).  Consecutive factors are multiplied into one as they come,
    through views, so the tape holds one factor between each two linear
    maps."""

    def __init__(self):
        self._steps = []         # factors (tensors or floats) and maps
        self._factor = None

    def scale(self, f) -> None:
        self._factor = f if self._factor is None else self._factor * f

    def linear(self, fn: Callable) -> None:
        self._flush()
        self._steps.append(fn)

    def view(self, fn: Callable) -> None:
        if torch.is_tensor(self._factor) and self._factor.dim() > 0:
            self._factor = fn(self._factor)
        self._steps.append(fn)

    def lse(self, e, contract: Callable, u) -> None:
        """A stage ``m + log(contract(e))``, ``e = exp(a - m)``, ``u =
        contract(e)``: its tangent ``contract(e * da) / u``."""
        self.scale(e)
        self.linear(contract)
        self.scale(torch.reciprocal(u))

    def branches(self, terms, out: Callable = None) -> None:
        """A sum ``sum_b out(post_b * fn_b(pre_b * v))`` over ``terms``,
        a list of ``(pre, fn, post)``: ``fn`` a linear map, ``pre`` and
        ``post`` factors or None, ``out`` a linear map or None."""
        f, terms = self._factor, list(terms)
        if f is None or all(pre is None for pre, _, _ in terms):
            self._flush()
        else:
            self._factor = None
            terms = [(f if pre is None else f * pre, fn, post)
                     for pre, fn, post in terms]
        self._steps.append(_Branches(terms, out))

    def _flush(self) -> None:
        if self._factor is not None:
            self._steps.append(self._factor)
            self._factor = None

    def finish(self) -> list:
        self._flush()
        return self._steps


def viewed(x, fn: Callable, tape=None):
    """``fn(x)`` for a reshape, permute or cast ``fn``, recording it on
    ``tape``."""
    if tape is not None:
        tape.view(fn)
    return fn(x)


def lse_step(a, m, contract: Callable, tape=None):
    """``m + log(contract(exp(a - m)))`` for the shift ``m``, recording the
    stage on ``tape``."""
    e = torch.exp(a - m)
    u = contract(e)
    if tape is not None:
        tape.lse(e, contract, u)
    return m + torch.log(u)


def log1p_epilogue(log_hwt, theta, beta: float, tape=None):
    """``log1p(beta * exp(log_hwt / theta))``, the log-space operators'
    epilogue, recording its factor ``q / ((1 + q) theta)`` on ``tape``."""
    q = beta * torch.exp(log_hwt / theta)
    if tape is not None:
        tape.scale(q / ((1 + q) * theta))
    return torch.log1p(q)


def replay(steps, v):
    """``v`` through the finished steps of a :class:`Tape`."""
    for s in steps:
        v = s(v) if callable(s) else v * s
    return v


def _factors(steps):
    """The stored tensors of ``steps`` (a step with ``factors()`` holds
    its own), each once."""
    seen = {}
    for s in steps:
        for f in s.factors() if hasattr(s, "factors") else (s,):
            if torch.is_tensor(f):
                seen.setdefault(id(f), f)
    return seen.values()


class Linearization:
    """Newton's ``v -> J(x) v - v`` of ``primal(ell, tape)`` at ``x``.

    The primal runs once, with a :class:`Tape`, on the first matvec (a
    frozen Newton step, whose Krylov solve makes none, builds nothing);
    every matvec then replays the tape.  The factors live as long as this
    object: the solver drops it when its Newton step ends.  A DTensor
    ``x`` builds and replays under ``ops/dtensor``'s constant lifting, the
    result on the tangent's placements."""

    def __init__(self, primal: Callable, x):
        self._primal = primal
        self._x = x
        self._steps = None

    @spanned("sdfs.tangent.build")
    def build(self) -> None:
        tape = Tape()
        with torch.no_grad():
            if is_dtensor(self._x):
                apply(lambda y: self._primal(y, tape), self._x)
            else:
                self._primal(self._x, tape)
        self._steps = tape.finish()
        self._x = None

    @spanned("sdfs.tangent.matvec")
    def __call__(self, v):
        if self._steps is None:
            self.build()
        with torch.no_grad():
            if is_dtensor(v):
                return apply(lambda t: replay(self._steps, t), v) - v
            if len(self._steps) == 1 and hasattr(self._steps[0],
                                                 "minus_identity"):
                # One step that subtracts v itself (a fused chain).
                return self._steps[0].minus_identity(v)
            return replay(self._steps, v) - v

    @property
    def nbytes(self) -> int:
        """Bytes of the stored factors (0 before the build)."""
        return sum(f.numel() * f.element_size()
                   for f in _factors(self._steps or ()))


def linearizable(primal: Callable) -> Callable:
    """The operator ``primal(ell)`` (DTensor-transparent,
    ``ops/dtensor.transparent``) with ``T.linearize(x)``, a
    :class:`Linearization` of ``primal(ell, tape)`` at ``x``, and
    ``T.primal``, for an operator that composes it."""
    T = transparent(primal)
    T.linearize = lambda x: Linearization(primal, x)
    T.primal = primal
    return T
