"""Two-phase (column-group / row-group) form of the 4-D log-space operators.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/two_phase.py`` for the
plain discrete SSY and GCY operand sets.  Grouping the four SSY state axes
as rows (h_lam, h_c) and columns (h_z, z) splits the per-axis chain into

    column phase:  contract next-h_z, then next-z      (touches only columns)
    row phase:     contract next-h_lam, then next-h_c  (touches only rows)

with the epilogue's additive terms separable into a row part and a
column part.  The six GCY axes fold into the same form by Kronecker
grouping (:func:`two_phase_operands_gcy`).  The streamed kernels (``kernels/streamed_two_phase.py``)
run each phase as one pass over the field; :func:`make_eager_two_phase_T`
is the plain eager evaluator of the same math — the kernels' tangent
(Newton's inner matvecs) and their agreement oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device

__all__ = ["TwoPhaseOperands", "two_phase_operands_ssy",
           "two_phase_operands_gcy", "make_eager_two_phase_T"]


@dataclasses.dataclass(frozen=True)
class TwoPhaseOperands:
    """Operands of a two-phase 4-D log-space operator (host float64).

    Field layout: ell[r1, r2, c1, c2] with rows (r1, r2) and columns
    (c1, c2).  The operator is

        a   = theta*ell - sub_row ⊕ sub_col                (sub_* optional)
        a   = LSE-contract axis c1 with W_c1               (column phase)
        a   = LSE-contract axis c2 with W_c2
        a   = LSE-contract axis r1 with W_r1               (row phase)
        a   = LSE-contract axis r2 with W_r2
        out = log1p(beta * exp((a + add_row ⊕ add_col) / theta))

    The fields match the JAX package's operand set one for one, so
    ``dataclasses.asdict`` of either converts to the other
    (``interop.operands_from_numpy``); ``perm``, ``inv_perm`` and
    ``state_shapes``, which the JAX package sets as attributes of its GCY
    sets, are fields here.  ``sub_row``, ``sub_col``, ``baseline_log_w``
    and ``mid_col`` belong to the baseline-normalized sets, which later
    slices port; the evaluators here reject them.
    """

    shapes: Tuple[int, int, int, int]
    W_r1: np.ndarray
    W_r2: np.ndarray
    W_c1: np.ndarray
    W_c2: np.ndarray
    add_row: np.ndarray                 # (n_r1, n_r2)
    add_col: np.ndarray                 # (n_c1, n_c2)
    theta: float
    beta: float
    sub_row: Optional[np.ndarray] = None
    sub_col: Optional[np.ndarray] = None
    baseline_log_w: Optional[np.ndarray] = None
    mid_col: Optional[np.ndarray] = None
    # Six-state sets: natural layout -> view layout (d, l, a, b, c, e),
    # its inverse, and the natural shapes.
    perm: Optional[Tuple[int, ...]] = None
    inv_perm: Optional[Tuple[int, ...]] = None
    state_shapes: Optional[Tuple[int, ...]] = None

    @property
    def c1_batched(self) -> bool:
        return self.W_c1.ndim == 3

    @property
    def c2_batched(self) -> bool:
        return self.W_c2.ndim == 3

    @property
    def has_sub(self) -> bool:
        return self.sub_row is not None

    @property
    def has_mid(self) -> bool:
        return self.mid_col is not None

    @property
    def is_plain(self) -> bool:
        """Shared factors and no baseline corrections: the only operand
        kind this slice evaluates."""
        return not (self.c1_batched or self.c2_batched or self.has_sub
                    or self.has_mid)


def _warn_ssy_f32_envelope(model, disc) -> None:
    """Warn when theta * (within-column-group log-w span) exceeds exp's
    f32 range for the plain SSY operands (the SSY log-linear solution's
    (h_z, z) part is separable from the rows, so the span is exact and
    row-independent)."""
    import warnings

    from ..models.ssy import ssy_loglinear_factory

    co = ssy_loglinear_factory(model).coefficients
    h_z = np.asarray(disc.h_z_states, np.float64)
    phi_i = co["A_hz"] * (h_z * 2 * model.phi_z**2 + model.phi_z**2)
    psi_ij = co["A_z"] * np.asarray(disc.z_states, np.float64)   # (i, j)
    col = phi_i[:, None] + psi_ij
    span = float(col.max() - col.min())
    if abs(model.theta) * span > 85.0:
        warnings.warn(
            f"theta * (within-column-group log-w span) ~ "
            f"{abs(model.theta) * span:.0f} exceeds float32's exp range "
            "(~85): the f32 tiled SSY operator will produce -inf/NaN on "
            "this grid (its joint column-group shifts cannot window per "
            "row). Shrink the z / h_z axes (Rouwenhorst spans grow like "
            "sqrt(n)), use discretization='tauchen', or the float64 "
            "operator (kernel='xla').",
            stacklevel=3)


def two_phase_operands_ssy(model, disc, baseline: Optional[str] = None
                           ) -> TwoPhaseOperands:
    """Two-phase operands for the discrete SSY operator: the plain
    factors (B_lam, Q_c | Q_hz, z_P)."""
    from .discrete_ssy import _ssy_factors

    if baseline is not None:
        raise NotImplementedError(
            "baseline='loglinear' operand sets (the normalized tier) are "
            "not ported yet; they land with ROADMAP queue A item 4")
    n_l, n_k, n_i, n_j = disc.shapes
    B_lam, A2, A3 = (t.numpy() for t in _ssy_factors(model, disc))
    add_row = np.broadcast_to(np.log(A2)[None, :], (n_l, n_k)).copy()
    add_col = np.log(A3)
    # f32 range guard: the column phase shifts over the joint (h_z, z)
    # group, so if theta * (log-w span within a column group) exceeds
    # exp's f32 range, whole rows underflow to exact zero.
    _warn_ssy_f32_envelope(model, disc)
    return TwoPhaseOperands(
        shapes=tuple(disc.shapes),
        W_r1=B_lam,
        W_r2=disc.h_c_Q.numpy(),
        W_c1=disc.h_z_Q.numpy(),
        W_c2=disc.z_P.numpy(),
        add_row=add_row, add_col=add_col,
        theta=float(model.theta), beta=float(model.beta))


def _kron(X, Y):
    """Dense Kronecker product (row-major pairing) in float64."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    return np.einsum("aA,bB->abAB", X, Y).reshape(
        X.shape[0] * Y.shape[0], X.shape[1] * Y.shape[1])


def two_phase_operands_gcy(model, disc, baseline: Optional[str] = None
                           ) -> TwoPhaseOperands:
    """Two-phase operands for the discrete six-state GCY operator via
    Kronecker grouping.

    The discrete GCY transitions all use shared per-axis matrices (the
    conditioning of the z_pi and z chains lives in the state ladders), so
    the six-axis chain folds exactly into a 4-D two-phase operand set:

        rows:    r1 = h_c               W_r1 = Qc
                 r2 = h_lam             W_r2 = B_lam (payoff folded)
        columns: c1 = (z (x) z_pi)      W_c1 = zP (x) zpiP
                 c2 = (h_z (x) h_zpi)   W_c2 = Qhz (x) Qhzpi

    log_A3 depends on (z, z_pi, h_z, h_zpi), a general (c1, c2) matrix,
    and log_A2 on h_c only.  The field view is ``ell[d, l, a, b, c, e]``
    (h_c, h_lam leading); ``perm`` / ``inv_perm`` carry the transposition
    from the natural ``(z, z_pi, h_z, h_c, h_zpi, h_lam)`` layout.
    """
    from .discrete_gcy import _gcy_factors, gcy_loglinear_parts

    if baseline is not None:
        if baseline != "loglinear":
            raise ValueError(f"unknown baseline {baseline!r}")
        raise NotImplementedError(
            "baseline='loglinear' operand sets (the normalized GCY tier) "
            "are not ported yet; they land with ROADMAP queue A item 5")
    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    B_lam, A2, A3 = (t.numpy() for t in _gcy_factors(model, disc))
    # log_A2 over d -> rows; log_A3 over current (a, b, c, e) -> columns.
    add_row = np.broadcast_to(np.log(A2)[:, None], (n_d, n_l)).copy()
    add_col = np.log(A3).reshape(n_a * n_b, n_c * n_e)
    # f32 range guard: the column phase shifts over the joint (z, z_pi)
    # and (h_z, h_zpi) groups; if theta * (log-linear ell span within a
    # column group) exceeds exp's f32 range, entire Kronecker rows
    # underflow to exact zero -> -inf/NaN.
    import warnings
    ell0 = gcy_loglinear_parts(model, disc)["ell0"]
    span = float((ell0.max(axis=(0, 1, 2, 4))
                  - ell0.min(axis=(0, 1, 2, 4))).max())
    if abs(model.theta) * span > 85.0:
        warnings.warn(
            f"theta * (within-column-group log-w span) ~ "
            f"{abs(model.theta) * span:.0f} exceeds float32's exp range "
            "(~85): the f32 tiled GCY operator will produce -inf/NaN on "
            "this grid. Shrink the z / h_z axes (Rouwenhorst spans grow "
            "like sqrt(n)), use discretization='tauchen', or the float64 "
            "operator (kernel='xla').", stacklevel=2)
    return TwoPhaseOperands(
        shapes=(n_d, n_l, n_a * n_b, n_c * n_e),
        W_r1=disc.h_c_Q.numpy(),
        W_r2=B_lam,
        W_c1=_kron(disc.z_P, disc.z_pi_P),
        W_c2=_kron(disc.h_z_Q, disc.h_zpi_Q),
        add_row=add_row, add_col=add_col,
        theta=float(model.theta), beta=float(model.beta),
        # Natural layout (a, b, c, d, e, l) -> view layout (d, l, a, b, c, e).
        perm=(3, 5, 0, 1, 2, 4), inv_perm=(2, 3, 4, 0, 5, 1),
        state_shapes=tuple(disc.shapes))


def make_eager_two_phase_T(ops: TwoPhaseOperands,
                           dtype: torch.dtype = torch.float32, *,
                           device="cuda") -> Callable:
    """Plain eager evaluator of a plain two-phase operand set.

    The same math as the streamed kernels with per-axis shifts at every
    contraction: their agreement oracle and their tangent (it is
    differentiable by ``torch.func``).  float32 contractions run in full
    FP32: on a CUDA device it raises while TF32 matmuls are allowed
    (``torch.backends.cuda.matmul.allow_tf32``, off by default), whose
    10-bit mantissa misses the operator's 1e-6-class accuracy.
    """
    if not ops.is_plain:
        raise NotImplementedError(
            "batched factors and baseline corrections (normalized and "
            "continuous operand sets) are not ported yet; see ROADMAP "
            "queue A")
    dev = resolve_device(device)
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    R, C = n_r1 * n_r2, n_c1 * n_c2
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    W_r1, W_r2, W_c1, W_c2 = map(cast, (ops.W_r1, ops.W_r2, ops.W_c1,
                                        ops.W_c2))
    add = cast(ops.add_row[:, :, None]
               + np.asarray(ops.add_col).reshape(-1)[None, None, :])
    theta, beta = float(ops.theta), float(ops.beta)

    def T(ell):
        if ell.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the eager two-phase operator needs full-FP32 "
                               "matmuls; set torch.backends.cuda.matmul."
                               "allow_tf32 = False")
        a = theta * ell.to(dtype).reshape(R, n_c1, n_c2)
        m = torch.amax(a, dim=1, keepdim=True)
        a = m + torch.log(torch.einsum("im,tmj->tij", W_c1,
                                       torch.exp(a - m)))
        m = torch.amax(a, dim=2, keepdim=True)
        a = m + torch.log(torch.einsum("jm,tim->tij", W_c2,
                                       torch.exp(a - m)))
        b = a.reshape(n_r1, n_r2, C)
        m = torch.amax(b, dim=0, keepdim=True)
        b = m + torch.log(torch.einsum("lm,mkt->lkt", W_r1,
                                       torch.exp(b - m)))
        m = torch.amax(b, dim=1, keepdim=True)
        b = m + torch.log(torch.einsum("km,lmt->lkt", W_r2,
                                       torch.exp(b - m)))
        log_hwt = b + add
        return torch.log1p(beta * torch.exp(log_hwt / theta)).reshape(
            ops.shapes)

    return T
