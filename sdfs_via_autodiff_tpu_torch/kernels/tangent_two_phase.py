"""Newton's tangent of a two-phase set with shared column factors, one
step of the tape, run as three hand-written CUDA passes.

The eager twin of such a set (``operators/two_phase.make_eager_two_phase_T``,
float32, c1 and c2 factors 2-D, not a DTensor) records its whole chain on
the tape as one :class:`TwoPhaseTangent`: the steps it would have recorded
(``ops/tangent.py``) and the five field-sized factors among them,

    J v = F5 * r2(F4 * r1(F3 * c2(F2 * c1(F1 * v)))),

F1 = theta E1, F2 = E2 / D1, F3 = E3 / D2, F4 = E4 / D3 and F5 = q / ((1 +
q) theta D4).  A CPU vector replays the steps (the plain version: the same
products and einsum contractions in the same order as the tape's replay);
a CUDA vector runs ``sdfs_tangent_chain`` of ``csrc/streamed_two_phase.cu``:

    1. c1 with F1 before and F2 after, in the primal pass B's split
       (:func:`tangent_split`): "full" the c1 pass on FP32 FMA (SSY's I =
       32), "deferred" the split-TF32 product of the deferred pass B
       (the GCY view's I = 512);
    2. c2 with F3 after: pass B's split-TF32 product;
    3. r1, F4, r2 and F5 (less v where Newton's ``J v - v`` is asked for
       and the tape holds nothing else): the row phase's layout.

The set's split and the kernels' weights are fixed when the twin is
built (:func:`fused_chain`): the twin's own float32 weights on its device,
and the transposes the passes read, formed there once.  A set with no
split at its shapes keeps the stages' steps.  A CUDA vector launches the
kernels or raises; there is no fallback.  The c2 product's operand is the
one field-sized workspace beyond the factors, and the result reuses it
where J % 4 == 0.  Each matvec counts ``sdfs.tangent.fused``;
``LAUNCHES`` counts the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ..operators.two_phase import TwoPhaseOperands
from ..ops.tangent import replay
from ..utils.profiling import count
from .streamed_two_phase import (_lib, _ptr, _raise_on, pass_b_layout,
                                 streamed_config, strip_row_layout)

__all__ = ["LAUNCHES", "TwoPhaseTangent", "fused_chain", "tangent_split"]

# Kernel launches since the last reset: the c1 pass ("full") or the c1
# product ("deferred"), the c2 product and the row phase.
LAUNCHES = {"tangent_c1": 0, "tangent_c1_mma": 0, "tangent_c2": 0,
            "tangent_row": 0}

_SPLITS = {"full": 0, "deferred": 1}
_INT_MAX = 2**31 - 1


def tangent_split(ops: TwoPhaseOperands) -> Optional[str]:
    """The tangent passes' split at the set's shapes, as the primal's pass
    B splits them (:func:`..kernels.streamed_two_phase.streamed_config`):
    "full" (c1 on the c1 pass's layout) where the primal runs "full" or,
    outside the streamed configurations, where the c1 pass has a layout;
    else "deferred" (c1 on the tensor cores) where J % 4 == 0; None when
    neither applies or the row phase has no layout (the set then keeps
    the stages' steps)."""
    L, K, I, J = ops.shapes
    if (strip_row_layout(L, K) is None or L * K * I * J > _INT_MAX):
        return None
    if streamed_config(ops) != "deferred" and pass_b_layout(I, J) is not None:
        return "full"
    return "deferred" if J % 4 == 0 else None


def fused_chain(ops: TwoPhaseOperands, dtype: torch.dtype, W_c1, W_c2,
                W_r1, W_r2) -> Optional[Callable[[list], "TwoPhaseTangent"]]:
    """How the eager twin of ``ops`` in ``dtype`` records its chain on
    Newton's tape: ``steps -> TwoPhaseTangent`` where the chain fuses
    (float32; c1 and c2 factors 2-D, not a pair set; a split at the set's
    shapes), else None (the stages one by one).  ``W_c1`` .. ``W_r2`` are
    the twin's weights on its device; the passes read W_c1 ("full") or
    its transpose ("deferred"), W_c2's transpose, W_r1 and W_r2."""
    if (dtype != torch.float32 or ops.c1_batched or ops.c2_batched
            or ops.is_pair):
        return None
    split = tangent_split(ops)
    if split is None:
        return None
    full = split == "full"
    weights = (W_c1 if full else None,
               None if full else W_c1.t().contiguous(),
               W_c2.t().contiguous(), W_r1, W_r2)
    shapes = tuple(ops.shapes)
    return lambda steps: TwoPhaseTangent(shapes, split, weights, steps)


def _check(name: str, t: torch.Tensor, device, numel: int) -> None:
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on {device}, got "
                        f"{t.dtype} on {t.device}")
    if t.numel() != numel or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"field of {numel} entries")


class TwoPhaseTangent:
    """``v -> J v`` of one two-phase primal, a single step of its tape.
    ``steps`` are what the primal recorded on a tape of its own: views,
    the five factors and the four contractions; ``split`` and ``weights``
    those of :func:`fused_chain` (``weights`` may be None where no CUDA
    vector comes)."""

    def __init__(self, shapes: tuple, split: str, weights: Optional[tuple],
                 steps: list):
        # The factors in row-major order (an einsum may hand back a
        # permuted layout), once per Newton step; the values are the same.
        steps = [s.contiguous() if torch.is_tensor(s) else s for s in steps]
        self.shapes, self.split = tuple(shapes), split
        self._weights, self._steps = weights, steps
        self._factors = [s for s in steps if torch.is_tensor(s)]
        if len(self._factors) != 5:
            raise ValueError("a two-phase chain stores five factors, got "
                             f"{len(self._factors)}")

    def factors(self):
        return iter(self._factors)

    def plain(self, v):
        """The plain version on any device: the steps' einsum replay."""
        return replay(self._steps, v)

    def __call__(self, v):
        count("sdfs.tangent.fused", 1)
        if v.is_cuda:
            return self._cuda(v, minus=False)
        return self.plain(v)

    def minus_identity(self, v):
        """``J v - v``: on a CUDA device the subtraction runs in the last
        pass."""
        if v.is_cuda and tuple(v.shape) == self.shapes:
            count("sdfs.tangent.fused", 1)
            return self._cuda(v, minus=True)
        return self(v) - v

    def _cuda(self, v, minus: bool):
        L, K, I, J = self.shapes
        R, C = L * K, I * J
        x = v.contiguous()
        dev = x.device
        _check("v", x, dev, R * C)
        for k, f in enumerate(self._factors, 1):
            _check(f"F{k}", f, dev, R * C)
        if self._weights is None or any(
                w is not None and w.device != dev for w in self._weights):
            raise ValueError(f"the tangent passes' weights are not on {dev}")
        w_c1, w_c1t, w_c2t, w_r1, w_r2 = self._weights
        Jp = -(-J // 4) * 4
        u = torch.empty((R * I * Jp,), dtype=torch.float32, device=dev)
        x3 = torch.empty((R * C,), dtype=torch.float32, device=dev)
        out = u if Jp == J else torch.empty_like(x3)
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.sdfs_tangent_chain(
                _ptr(x), *map(_ptr, self._factors), _ptr(w_c1), _ptr(w_c1t),
                _ptr(w_c2t), _ptr(w_r1), _ptr(w_r2), _ptr(u), _ptr(x3),
                _ptr(out), L, K, I, J, _SPLITS[self.split], int(minus),
                ctypes.c_void_p(stream))
        _raise_on(lib, rc, "tangent")
        LAUNCHES["tangent_c1" if self.split == "full"
                 else "tangent_c1_mma"] += 1
        LAUNCHES["tangent_c2"] += 1
        LAUNCHES["tangent_row"] += 1
        return out[:R * C].view(self.shapes)
