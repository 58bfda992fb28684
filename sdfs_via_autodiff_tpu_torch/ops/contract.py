"""Log-sum-exp factored contractions (PyTorch port of ``ops/contract.py``).

``log(M @ exp(a))`` computed with a shift along the contracted axis:

    m = max(a, axis); result = m + log(M @ exp(a - m))

A single global shift overflows float32 once the iterate's dynamic range
exceeds exp's range; the per-axis shifts here are exact and cost one
max/exp/log per contraction step.

The deep multi-window passes (``deep_window``/``deep_passes``) serve the
baseline-normalized float32 tier, with the construction-time row
normalization :func:`normalize_rows_log`.  The TPU's software
transcendentals and bf16 "3x" splits are not ported (CUDA's ``exp``/``log``
are correctly rounded to ~1 ulp, and float32 contractions run in full
FP32).
"""

from __future__ import annotations

import numpy as np
import torch

from .tangent import lse_step

__all__ = ["lse_matmul", "normalize_rows_log"]


def _contracted_dims(subscripts, axis):
    """(ms, out, kdim, contracted): M's labels, output labels, the
    position of the contracted label within M, and that label."""
    ins, out = subscripts.split("->")
    ms, vs = ins.split(",")
    contracted = vs[axis]
    return ms, out, ms.index(contracted), contracted


def _scale_to_output(s, ms, out, contracted):
    """Reshape a per-row scale ``s`` (M's non-contracted labels, in M
    order; a tensor or a numpy array) to broadcast against the einsum
    OUTPUT."""
    labels = [l for l in ms if l != contracted]
    if not all(l in out for l in labels):
        raise ValueError(f"every non-contracted label of {ms!r} must "
                         f"appear in the output {out!r}")
    order = sorted(range(len(labels)), key=lambda i: out.index(labels[i]))
    s_t = (np.transpose(s, order) if isinstance(s, np.ndarray)
           else s.permute(order))
    shape, i = [], 0
    for l in out:
        if i < len(labels) and l == labels[order[i]]:
            shape.append(s_t.shape[i])
            i += 1
        else:
            shape.append(1)
    return s_t.reshape(shape)


def _rowsum_align(M, subscripts, axis):
    """Row-normalize ``M`` over its contracted label, returning the
    normalized matrix and ``log(rowsum)`` reshaped to broadcast against
    the einsum OUTPUT.  Exact (``log s + log(M^ @ e^v)``); keeps folded
    payoff factors from eating into the exp window."""
    ms, out, kdim, contracted = _contracted_dims(subscripts, axis)
    s = M.sum(dim=kdim)
    Mn = M / torch.where(s == 0, torch.ones_like(s), s).unsqueeze(kdim)
    return Mn, torch.log(_scale_to_output(s, ms, out, contracted))


def normalize_rows_log(logM, subscripts, axis):
    """Construction-time (host numpy, float64) log-domain row
    normalization for an :func:`lse_matmul` operand.

    Folded baseline factors reach e^{+-hundreds} on wide-Rouwenhorst
    grids, so a float32 cast of ``exp(logM)`` would make inf and 0
    entries.  Returns ``(Mn, log_s)`` with ``Mn = exp(logM -
    logsumexp_row)`` (max entry per row >= 1/n) and ``log_s`` (float64)
    reshaped to broadcast against the einsum output, to be added to the
    contraction's result.  As in the JAX package, a row that is all -inf
    gives NaN (its shift is 0 and its log-sum -inf).
    """
    ms, out, kdim, contracted = _contracted_dims(subscripts, axis)
    mx = np.max(logM, axis=kdim, keepdims=True)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    log_s = (np.squeeze(mx, kdim)
             + np.log(np.sum(np.exp(logM - mx), axis=kdim)))
    Mn = np.exp(logM - np.expand_dims(log_s, kdim))
    return Mn, _scale_to_output(log_s, ms, out, contracted)


def _safe_shift(log_v, axis):
    """Per-slice max shift; 0 for all--inf slices (-inf - -inf = NaN)."""
    m = torch.amax(log_v, dim=axis, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


# Window-selection floor: the smallest NORMAL float32.  A subnormal
# contraction result carries as few as 1-2 mantissa bits, so log(u) would
# quantize in ~0.1-nat steps; such rows fall through to the deeper window.
_MIN_NORMAL_F32 = float(np.finfo(np.float32).tiny)
# Cap of a shifted window's exponents (e^80 < float32 max): a capped term
# only matters for rows a shallower window serves, and the cap prevents
# 0 * inf = NaN against exact-zero matrix entries.  As in the JAX package
# the cap is 80 whatever the window W, so with W > 80 terms are dropped.
_EXP_CAP = 80.0


def _deep_passes(Mn, log_v, subscripts, axis, W, K):
    """K-window LSE of a row-normalized ``Mn``: pass k shifts by k*W, and
    per output element the shallowest pass whose contraction stayed
    normal is selected."""
    m = _safe_shift(log_v, axis)
    d = log_v - m
    u = torch.einsum(subscripts, Mn, torch.exp(d))
    out = m + torch.log(u)
    sel = u >= _MIN_NORMAL_F32
    for k in range(1, K):
        s = k * W
        u_k = torch.einsum(subscripts, Mn,
                           torch.exp(torch.clamp(d + s, max=_EXP_CAP)))
        out = torch.where(sel, out, m - s + torch.log(u_k))
        sel = sel | (u_k >= _MIN_NORMAL_F32)
    return out


def _deep_windows(Mn, log_v, subscripts, axis, W, K):
    """The windows of the derivative: for each shift k*W (k = 1 ..
    max(K, 2) - 1), ``(em, u, first)`` with em = exp(min(v - m + kW,
    80)), u its contraction with u's flushed entries set to 1, and
    ``first`` the output elements this window is the shallowest normal
    one of."""
    m = _safe_shift(log_v, axis)
    d = log_v - m
    served = None
    for k in range(1, max(K, 2)):
        em = torch.exp(torch.clamp(d + k * W, max=_EXP_CAP))
        u_k = torch.einsum(subscripts, Mn, em)
        ok = u_k >= _MIN_NORMAL_F32
        if served is None:
            served = torch.zeros_like(ok)
        yield em, torch.where(ok, u_k, torch.ones_like(u_k)), ~served & ok
        served = served | ok


class _LseMatmulDeep(torch.autograd.Function):
    """Multi-window LSE contraction with derivatives that cost one einsum
    per window, not per pass of the primal.

    For every window the exact derivative is the softmax average
    ``(Mn @ (exp(v - m + s) dv)) / u_s`` for any shift s whose
    contraction u_s stayed normal, so the tangent needs only the K-1
    shifted windows W, 2W, ... (window W covers what the unshifted pass
    covers), each selected per output element at the shallowest
    non-flushed shift.  Rows deeper than the deepest window get a zero
    tangent row.  ``torch.func.jvp`` reaches it through ``jvp``;
    ``backward`` is its transpose (the JAX package's ``custom_jvp``,
    which JAX transposes for reverse mode): each window's outputs take
    the cotangent over u_s, contracted back through ``Mn`` and scaled by
    the window's exponentials, so the rows beyond the deepest window
    send back nothing.  Both are plain torch operations, so reverse mode
    over ``backward`` (a JVP as the derivative of a VJP) works too."""

    @staticmethod
    def forward(Mn, log_v, subscripts, axis, W, K):
        return _deep_passes(Mn, log_v, subscripts, axis, W, K)

    @staticmethod
    def setup_context(ctx, inputs, output):
        Mn, log_v, subscripts, axis, W, K = inputs
        ctx.save_for_forward(Mn, log_v)
        ctx.save_for_backward(Mn, log_v)
        ctx.spec = (subscripts, axis, W, K)

    @staticmethod
    def jvp(ctx, dM, dv, *_):
        Mn, log_v = ctx.saved_tensors
        subscripts, axis, W, K = ctx.spec
        dout = None
        for em, u_k, first in _deep_windows(Mn, log_v, *ctx.spec):
            num = torch.zeros_like(u_k)
            if dv is not None:
                num = torch.einsum(subscripts, Mn, em * dv)
            if dM is not None:
                num = num + torch.einsum(subscripts, dM, em)
            val = num / u_k
            if dout is None:
                dout = torch.zeros_like(val)
            dout = torch.where(first, val, dout)
        return dout

    @staticmethod
    def backward(ctx, ct):
        Mn, log_v = ctx.saved_tensors
        subscripts = ctx.spec[0]
        ms, vs = subscripts.split("->")[0].split(",")
        out = subscripts.split("->")[1]
        want_M, want_v = ctx.needs_input_grad[:2]
        gM = gv = None
        for em, u_k, first in _deep_windows(Mn, log_v, *ctx.spec):
            c = torch.where(first, ct / u_k, torch.zeros_like(ct))
            if want_v:
                t = em * torch.einsum(f"{ms},{out}->{vs}", Mn, c)
                gv = t if gv is None else gv + t
            if want_M:
                t = torch.einsum(f"{vs},{out}->{ms}", em, c)
                gM = t if gM is None else gM + t
        return gM, gv, None, None, None, None


def _record_deep(tape, Mn, log_v, spec) -> None:
    """The deep windows' tangent on ``tape``: one branch per window k,
    ``pre`` its exponentials em_k, ``post`` one over its contraction
    where it is the shallowest normal window and 0 elsewhere, the map
    the contraction itself.  This is :meth:`_LseMatmulDeep.jvp`'s sum,
    factor by factor: the rows beyond the deepest window keep a zero
    tangent, and no product is flushed."""
    contract = lambda t: torch.einsum(spec[0], Mn, t)
    terms = []
    for em, u_k, first in _deep_windows(Mn, log_v, *spec):
        post = torch.where(first, torch.reciprocal(u_k),
                           torch.zeros_like(u_k))
        terms.append((em, contract, post))
    tape.branches(terms)


def lse_matmul(M: torch.Tensor, log_v: torch.Tensor, subscripts: str,
               axis: int, deep_window: float = 0.0,
               deep_passes: int = 2, tape=None) -> torch.Tensor:
    """log of ``einsum(subscripts, M, exp(log_v))`` with a per-slice shift
    over the contracted ``axis`` of ``log_v``.

    ``subscripts`` must contract exactly the given axis of ``log_v`` and
    produce an output that broadcasts against
    ``max(log_v, axis, keepdim=True)``.  All entries of ``M`` must be
    non-negative; ``M`` is row-normalized internally (see
    :func:`_rowsum_align`).

    ``deep_window=W`` (float32 inputs only, e.g. 80.0) adds passes with
    the shift lowered by W, 2W, ... (``deep_passes`` in all): a localized
    output row, e.g. a Rouwenhorst ladder corner, can have its whole mass
    below the single window (exp(v - m) flushes to 0), and the deeper
    window represents it (:func:`_deep_passes`).

    ``tape`` (``ops/tangent.Tape``) records the contraction's tangent for
    Newton's linearization.  The deep windows record theirs as branches
    (:func:`_record_deep`).
    """
    M, log_s = _rowsum_align(M, subscripts, axis)
    if deep_window and log_v.dtype == torch.float32:
        spec = (subscripts, axis, float(deep_window), int(deep_passes))
        if tape is not None:
            _record_deep(tape, M, log_v, spec)
        return _LseMatmulDeep.apply(M, log_v, *spec) + log_s
    return lse_step(log_v, _safe_shift(log_v, axis),
                    lambda t: torch.einsum(subscripts, M, t), tape) + log_s
