"""Two-phase (column-group / row-group) form of the 4-D log-space operators.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/two_phase.py`` for the
plain discrete SSY and GCY operand sets, the continuous-SSY sets (c2
batched over the current c1 index, with or without a folded baseline)
and the continuous-GCY pair sets.  Grouping the four SSY state axes
as rows (h_lam, h_c) and columns (h_z, z) splits the per-axis chain into

    column phase:  contract next-h_z, then next-z      (touches only columns)
    row phase:     contract next-h_lam, then next-h_c  (touches only rows)

with the epilogue's additive terms separable into a row part and a
column part.  The six GCY axes fold into the same form by Kronecker
grouping (:func:`two_phase_operands_gcy`, discrete;
:func:`two_phase_operands_gcy_continuous`, continuous).  The streamed kernels (``kernels/streamed_two_phase.py``)
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
           "two_phase_operands_ssy_continuous", "two_phase_operands_gcy",
           "two_phase_operands_gcy_continuous", "make_eager_two_phase_T"]


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
    (``interop.operands_from_numpy``); ``perm``, ``inv_perm``,
    ``state_shapes``, ``pair_c2`` and ``pair_shapes``, which the JAX
    package sets as attributes of its six-state sets, are fields here.
    ``W_c2`` is (n_c2, n_c2), or (n_c1, n_c2, n_c2) batched over the
    current c1 index (continuous SSY's P_z).  ``sub_row``/``sub_col`` (the
    folded baseline theta*ell0 split over rows and columns) and
    ``baseline_log_w`` (ell0 itself) belong to the baseline-normalized
    sets; ``mid_col`` to the conjugated-shared ones, which a later slice
    ports (the evaluators here reject it).

    Continuous-GCY sets carry their column factor c2 = (z_pi, z) as the
    per-axis pair ``pair_c2 = (P_z (i, j, b, J), P_zpi (y, b, B))`` with
    ``pair_shapes = (n_i, n_y, n_b, n_j)``; their ``W_c2`` is None (the
    joint factor, batched over the current c1 slice, is never built).
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
    # Continuous-GCY sets: (P_z, P_zpi) and (n_i, n_y, n_b, n_j).
    pair_c2: Optional[Tuple[np.ndarray, np.ndarray]] = None
    pair_shapes: Optional[Tuple[int, int, int, int]] = None

    @property
    def c1_batched(self) -> bool:
        return self.W_c1.ndim == 3

    @property
    def is_pair(self) -> bool:
        return self.pair_c2 is not None

    @property
    def c2_batched(self) -> bool:
        """True when the c2 factor depends on the current c1 index (a
        batched ``W_c2``, or a pair set, whose P_z and P_zpi condition on
        the c1 slice's (h_z, h_zpi))."""
        return self.is_pair or self.W_c2.ndim == 3

    @property
    def has_sub(self) -> bool:
        return self.sub_row is not None

    @property
    def has_mid(self) -> bool:
        return self.mid_col is not None

    @property
    def is_plain(self) -> bool:
        """Shared factors and no baseline corrections."""
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


def two_phase_operands_ssy_continuous(model, grids, degree: int = 5,
                                      baseline=None) -> TwoPhaseOperands:
    """Two-phase operands for the continuous factored-quadrature SSY
    operator (interp="pre"):

        rows:    r1 = h_lam (l)   W_r1 = P_lam (payoff folded)
                 r2 = h_c   (k)   W_r2 = P_c
        columns: c1 = h_z   (i)   W_c1 = P_hz (shared)
                 c2 = z     (j)   W_c2 = P_z (i, j, j'), batched over the
                                  current h_z index (z' = rho z +
                                  sigma_z(h_z) eta)

    log kappa(h_c, z) splits into ``add_row`` (h_c) and ``add_col`` (z).
    ``baseline`` ("loglinear" or a ``(const, profiles)`` pair, see
    ``continuous_ssy._factored_arrays_ssy``) folds a separable baseline:
    ``sub_row``/``sub_col`` split theta*ell0 over rows and columns,
    ``add_*`` restore it, ``baseline_log_w`` is ell0.
    """
    from .continuous_ssy import _factored_arrays_ssy

    shapes = tuple(len(g) for g in grids)
    n_l, n_k, n_i, n_j = shapes
    theta, beta = float(model.theta), float(model.beta)
    arrs = _factored_arrays_ssy(model, grids, degree, baseline)
    f64 = lambda a: np.asarray(a, np.float64)
    log_A2, log_A3 = f64(arrs["log_A2"]), f64(arrs["log_A3"])
    add_row = np.broadcast_to(log_A2[None, :], (n_l, n_k)).copy()
    add_col = np.broadcast_to(log_A3[None, :], (n_i, n_j)).copy()
    sub_row = sub_col = ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_j = (
            f64(p) for p in arrs["ell0_parts"])
        sub_row = theta * (phi_l[:, None] + phi_k[None, :])
        sub_col = theta * (const0 + phi_i[:, None] + phi_j[None, :])
        add_row = add_row + sub_row
        add_col = add_col + sub_col
        ell0 = (const0 + phi_l[:, None, None, None]
                + phi_k[None, :, None, None]
                + phi_i[None, None, :, None] + phi_j[None, None, None, :])
    return TwoPhaseOperands(
        shapes=shapes, W_r1=f64(arrs["P_lam"]), W_r2=f64(arrs["P_c"]),
        W_c1=f64(arrs["P_hz"]), W_c2=f64(arrs["P_z"]),
        add_row=add_row, add_col=add_col, theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0)


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


def two_phase_operands_gcy_continuous(model, grids, degree: int = 5,
                                      baseline=None) -> TwoPhaseOperands:
    """Two-phase operands for the continuous six-state GCY
    factored-quadrature operator (interp="pre").

    Grouping (view layout ``ell[k, l, (i, y), (b, j)]``, natural order
    (l, k, i, y, j, b) carried by ``perm``/``inv_perm``):

        rows:    r1 = h_c  (k)          W_r1 = P_c
                 r2 = h_lam (l)         W_r2 = P_lam (payoff folded)
        columns: c1 = (h_z (x) h_zpi)   W_c1 = P_hz (x) P_hzpi  (shared)
                 c2 = (z_pi, z), z minor

    The continuous z/z_pi expectation matrices are truly conditioned:
    P_zpi on the current h_zpi (y), P_z on the current h_z (i) and z_pi
    (b).  The joint c2 factor batched over the current c1 slice,

        W_c2[(i, y)][(b, j), (B, J)] = P_zpi[y, b, B] * P_z[i, j, b, J],

    is exact (P_z's z_pi conditioning is on the current b, a row index of
    the joint matrix) but never built: ``pair_c2 = (P_z, P_zpi)`` and
    ``pair_shapes`` carry the per-axis factors, which pass C's pair
    kernel and the eager twin contract per axis; ``W_c2`` is None.

    ``baseline`` is "loglinear" or a ``(const, profiles)`` pair from a
    coarse solve (``operators.continuous_common.additive_profiles``):
    effectively required for float32 (GCY's theta = -36 puts
    theta*(log-w range) ~ 200 on reference-style grids).  The fold is
    separable, so sub/add split into rows and columns exactly.
    """
    from .continuous_gcy import _factored_arrays_gcy

    n_l, n_k, n_i, n_y, n_j, n_b = (len(g) for g in grids)
    IY, C2 = n_i * n_y, n_b * n_j
    theta, beta = float(model.theta), float(model.beta)
    arrs = _factored_arrays_gcy(model, grids, degree, baseline)
    f64 = lambda a: np.asarray(a, np.float64)
    W_c1 = _kron(f64(arrs["P_hz"]), f64(arrs["P_hzpi"]))
    P_z = f64(arrs["P_z"])                           # (i, j, b, J)
    P_zpi = f64(arrs["P_zpi"])                       # (y, b, B)
    # Row-normalize P_zpi, moving log(rowsum) into the per-column add.
    # The raw rows carry folded payoff factors that sum to ~e^38 on
    # reference calibrations, which would waste most of pass C's linear
    # chain's float32 window on a constant scale.  A per-(y, b) scale
    # rides the b lane through the row contractions (they contract rows,
    # never columns), so the move is exact.
    zpi_scale = P_zpi.sum(axis=2)                    # (y, b)
    P_zpi = P_zpi / np.where(zpi_scale == 0.0, 1.0, zpi_scale)[:, :, None]
    with np.errstate(divide="ignore"):               # 0-mass row -> -inf
        log_zpi_scale = np.log(zpi_scale)
    log_A2, log_A3 = f64(arrs["log_A2"]), f64(arrs["log_A3"])
    add_row = np.broadcast_to(log_A2[:, None], (n_k, n_l)).copy()
    colpart = np.broadcast_to(log_A3[None, :], (n_b, n_j)).reshape(C2)
    add_col = np.broadcast_to(colpart[None, :], (IY, C2)).copy()
    add_col += np.tile(
        np.broadcast_to(log_zpi_scale[:, :, None],
                        (n_y, n_b, n_j)).reshape(n_y, C2), (n_i, 1))
    sub_row = sub_col = ell0 = None
    if arrs["ell0_parts"] is not None:
        const0, phi_l, phi_k, phi_i, phi_y, phi_j, phi_b = (
            np.asarray(p, np.float64) if not np.isscalar(p) else p
            for p in arrs["ell0_parts"])
        phi_iy = (phi_i[:, None] + phi_y[None, :]).reshape(IY)
        phi_bj = (phi_b[:, None] + phi_j[None, :]).reshape(C2)
        sub_row = theta * (phi_k[:, None] + phi_l[None, :])
        sub_col = theta * (const0 + phi_iy[:, None] + phi_bj[None, :])
        add_row = add_row + sub_row
        add_col = add_col + sub_col
        ell0 = (const0 + phi_k[:, None, None, None]
                + phi_l[None, :, None, None]
                + phi_iy[None, None, :, None] + phi_bj[None, None, None, :])
    return TwoPhaseOperands(
        shapes=(n_k, n_l, IY, C2),
        W_r1=f64(arrs["P_c"]), W_r2=f64(arrs["P_lam"]), W_c1=W_c1, W_c2=None,
        add_row=add_row, add_col=add_col, theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0,
        # Natural (l, k, i, y, j, b) -> view (k, l, i, y, b, j); self-inverse.
        perm=(1, 0, 2, 3, 5, 4), inv_perm=(1, 0, 2, 3, 5, 4),
        state_shapes=(n_l, n_k, n_i, n_y, n_j, n_b),
        pair_c2=(P_z, P_zpi), pair_shapes=(n_i, n_y, n_b, n_j))


def make_eager_two_phase_T(ops: TwoPhaseOperands,
                           dtype: torch.dtype = torch.float32, *,
                           device="cuda") -> Callable:
    """Plain eager evaluator of a two-phase operand set with a shared c1
    factor and a shared or batched c2 factor (plain, or with a folded
    baseline ``sub_row``/``sub_col``) or a continuous-GCY pair set.

    The same math as the streamed kernels with per-axis shifts at every
    contraction: their agreement oracle and their tangent (it is
    differentiable by ``torch.func``).  A batched c2 step contracts each
    c1 slice with its own factor, ``einsum("ijm,tim->tij")`` as in the
    JAX package's XLA twin.  A pair set's c2 step takes one
    shift over the whole (B', J') slice, then contracts next-z_pi with
    P_zpi and next-z with P_z, as the JAX package's XLA twin does.
    float32 contractions run in full FP32: on a CUDA device it raises
    while TF32 matmuls are allowed
    (``torch.backends.cuda.matmul.allow_tf32``, off by default), whose
    10-bit mantissa misses the operator's 1e-6-class accuracy.
    """
    if ops.c1_batched or ops.has_mid:
        raise NotImplementedError(
            "batched c1 factors and mid_col corrections (the normalized "
            "discrete operand sets) are not ported yet; see ROADMAP A3")
    dev = resolve_device(device)
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    R, C = n_r1 * n_r2, n_c1 * n_c2
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    W_r1, W_r2, W_c1 = map(cast, (ops.W_r1, ops.W_r2, ops.W_c1))
    if ops.is_pair:
        P_z, P_zpi = map(cast, ops.pair_c2)      # (i, j, b, J), (y, b, B)
        n_i, n_y, n_b, n_j = ops.pair_shapes
    else:
        W_c2 = cast(ops.W_c2)
        c2_sub = "ijm,tim->tij" if ops.c2_batched else "jm,tim->tij"
    add = cast(ops.add_row[:, :, None]
               + np.asarray(ops.add_col).reshape(-1)[None, None, :])
    sub = None
    if ops.has_sub:
        sub = cast(np.asarray(ops.sub_row).reshape(-1)[:, None, None]
                   + np.asarray(ops.sub_col)[None, :, :])    # (R, c1, c2)
    theta, beta = float(ops.theta), float(ops.beta)

    def T(ell):
        if ell.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the eager two-phase operator needs full-FP32 "
                               "matmuls; set torch.backends.cuda.matmul."
                               "allow_tf32 = False")
        a = theta * ell.to(dtype).reshape(R, n_c1, n_c2)
        if sub is not None:
            a = a - sub
        m = torch.amax(a, dim=1, keepdim=True)
        a = m + torch.log(torch.einsum("im,tmj->tij", W_c1,
                                       torch.exp(a - m)))
        m = torch.amax(a, dim=2, keepdim=True)
        if ops.is_pair:
            e = torch.exp(a - m).reshape(R, n_i, n_y, n_b, n_j)
            v = torch.einsum("ybB,tiyBJ->tiybJ", P_zpi, e)
            u = torch.einsum("ijbJ,tiybJ->tiybj", P_z, v)
            a = m + torch.log(u.reshape(R, n_c1, n_c2))
        else:
            a = m + torch.log(torch.einsum(c2_sub, W_c2, torch.exp(a - m)))
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
