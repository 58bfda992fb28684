"""Log-sum-exp factored contractions (PyTorch port of ``ops/contract.py``).

``log(M @ exp(a))`` computed with a shift along the contracted axis:

    m = max(a, axis); result = m + log(M @ exp(a - m))

A single global shift overflows float32 once the iterate's dynamic range
exceeds exp's range; the per-axis shifts here are exact and cost one
max/exp/log per contraction step.

Only the plain single-window path is ported.  The deep multi-window
passes (``deep_window``/``deep_passes``) serve the baseline-normalized
tier, which a later slice ports; the TPU's software transcendentals and
bf16 "3x" splits are not ported (CUDA's ``exp``/``log`` are correctly
rounded to ~1 ulp, and float32 contractions run in full FP32).
"""

from __future__ import annotations

import torch

__all__ = ["lse_matmul"]


def _contracted_dims(subscripts, axis):
    """(ms, out, kdim, contracted): M's labels, output labels, the
    position of the contracted label within M, and that label."""
    ins, out = subscripts.split("->")
    ms, vs = ins.split(",")
    contracted = vs[axis]
    return ms, out, ms.index(contracted), contracted


def _scale_to_output(s, ms, out, contracted):
    """Reshape a per-row scale ``s`` (M's non-contracted labels, in M
    order) to broadcast against the einsum OUTPUT."""
    labels = [l for l in ms if l != contracted]
    if not all(l in out for l in labels):
        raise ValueError(f"every non-contracted label of {ms!r} must "
                         f"appear in the output {out!r}")
    order = sorted(range(len(labels)), key=lambda i: out.index(labels[i]))
    s_t = s.permute(order)
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


def _safe_shift(log_v, axis):
    """Per-slice max shift; 0 for all--inf slices (-inf - -inf = NaN)."""
    m = torch.amax(log_v, dim=axis, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def lse_matmul(M: torch.Tensor, log_v: torch.Tensor, subscripts: str,
               axis: int) -> torch.Tensor:
    """log of ``einsum(subscripts, M, exp(log_v))`` with a per-slice shift
    over the contracted ``axis`` of ``log_v``.

    ``subscripts`` must contract exactly the given axis of ``log_v`` and
    produce an output that broadcasts against
    ``max(log_v, axis, keepdim=True)``.  All entries of ``M`` must be
    non-negative; ``M`` is row-normalized internally (see
    :func:`_rowsum_align`).
    """
    M, log_s = _rowsum_align(M, subscripts, axis)
    m = _safe_shift(log_v, axis)
    u = torch.einsum(subscripts, M, torch.exp(log_v - m))
    return m + torch.log(u) + log_s
