"""Two-phase (column-group / row-group) form of the 4-D log-space operators.

PyTorch port of ``sdfs_via_autodiff_tpu/operators/two_phase.py``: the
discrete SSY and GCY operand sets, plain and baseline-normalized (batched
column factors with lazy forms, and their conjugated-shared form,
:func:`conjugate_to_shared`), the continuous-SSY sets (c2 batched over
the current c1 index, with or without a folded baseline) and the
continuous-GCY pair sets.  Grouping the four SSY state axes
as rows (h_lam, h_c) and columns (h_z, z) splits the per-axis chain into

    column phase:  contract next-h_z, then next-z      (touches only columns)
    row phase:     contract next-h_lam, then next-h_c  (touches only rows)

with the epilogue's additive terms separable into a row part and a
column part.  The six GCY axes fold into the same form by Kronecker
grouping (:func:`two_phase_operands_gcy`, discrete;
:func:`two_phase_operands_gcy_continuous`, continuous).  The streamed kernels (``kernels/streamed_two_phase.py``)
run each phase as one pass over the field; :func:`make_eager_two_phase_T`
is the plain eager evaluator of the same math — the kernels' tangent
(Newton's inner matvecs, through its ``linearize``) and their agreement
oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.dtensor import is_dtensor
from ..ops.tangent import Tape, linearizable, lse_step, log1p_epilogue, viewed
from ..utils.profiling import spanned

__all__ = ["TwoPhaseOperands", "two_phase_operands_ssy",
           "two_phase_operands_ssy_continuous", "two_phase_operands_gcy",
           "two_phase_operands_gcy_continuous", "conjugate_to_shared",
           "make_eager_two_phase_T", "eager_column_phase"]


@dataclasses.dataclass(frozen=True)
class TwoPhaseOperands:
    """Operands of a two-phase 4-D log-space operator (host float64).

    Field layout: ell[r1, r2, c1, c2] with rows (r1, r2) and columns
    (c1, c2).  The operator is

        a   = theta*ell - sub_row ⊕ sub_col                (sub_* optional)
        a   = LSE-contract axis c1 with W_c1               (column phase)
        a   = a + mid_col                                  (optional)
        a   = LSE-contract axis c2 with W_c2
        a   = LSE-contract axis r1 with W_r1               (row phase)
        a   = LSE-contract axis r2 with W_r2
        out = log1p(beta * exp((a + add_row ⊕ add_col) / theta))

    The fields match the JAX package's operand set one for one, so
    ``dataclasses.asdict`` of either converts to the other
    (``interop.operands_from_numpy``); ``perm``, ``inv_perm``,
    ``state_shapes``, ``pair_c2``, ``pair_shapes``, ``lazy_c1``,
    ``lazy_c2`` and ``dense_placeholder``, which the JAX package sets as
    attributes, are fields here.  ``W_c1`` is (n_c1, n_c1), or
    (n_c2, n_c1, n_c1) batched over the *next* c2 index (it applies
    before c2 is contracted); ``W_c2`` is (n_c2, n_c2), or
    (n_c1, n_c2, n_c2) batched over the current c1 index (continuous
    SSY's P_z, the normalized sets' folded factors).  ``sub_row``/
    ``sub_col`` (the folded baseline theta*ell0 split over rows and
    columns) and ``baseline_log_w`` (ell0 itself) belong to the
    baseline-normalized sets; ``mid_col`` (n_c1, n_c2), added between the
    two column contractions, to conjugated-shared ones
    (:func:`conjugate_to_shared`).

    ``lazy_c1``/``lazy_c2`` are the lazy forms of batched column factors,
    ``(logW0 (n, n), D (K, n, n), t (K, B))`` with
    ``W[b] = exp(logW0 + sum_k t[k, b] D[k])`` (rank 1 for SSY, 2 for
    GCY); the strip kernels build slices from them instead of reading a
    dense (B, n, n) tensor.  ``dense_placeholder`` marks a set built with
    ``dense=False``, whose batched ``W_c1``/``W_c2`` are broadcast
    placeholders carrying only the shape.

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
    # Normalized discrete sets: lazy forms of the batched column factors.
    lazy_c1: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    lazy_c2: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    dense_placeholder: bool = False

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


@spanned("sdfs.build.operands")
def two_phase_operands_ssy(model, disc, baseline: Optional[str] = None
                           ) -> TwoPhaseOperands:
    """Two-phase operands for the discrete SSY operator.

    ``baseline=None`` groups the plain factors (B_lam, Q_c | Q_hz, z_P);
    ``baseline="loglinear"`` groups the folded factors M1..M4 of the
    normalized operator (``discrete_ssy._ssy_normalized_arrays``): W_c1
    batched over the next z index, W_c2 over the current h_z index, with
    their rank-1 lazy forms.
    """
    from .discrete_ssy import _log_probs, _ssy_factors, _ssy_normalized_arrays

    n_l, n_k, n_i, n_j = disc.shapes
    theta, beta = float(model.theta), float(model.beta)
    if baseline is None:
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
            add_row=add_row, add_col=add_col, theta=theta, beta=beta)
    if baseline != "loglinear":
        raise ValueError(f"unknown baseline {baseline!r}")
    arrs = _ssy_normalized_arrays(model, disc)
    # f32 range guard for the normalized operator: large positive entries
    # of the folded factors M3/M4 eat the exp-range headroom the LSE
    # accumulations and the iterate's residual theta*(ell - ell0) need
    # (the JAX package measured log max(M3) ~ 69 on a grid that gives NaN,
    # <= ~22 on good wide grids): warn above 45.
    import warnings
    fac_max = max(float(np.log(arrs["M3"].max())),
                  float(np.log(arrs["M4"].max())))
    if fac_max > 45.0:
        warnings.warn(
            f"normalized-operator folded factors reach e^{fac_max:.0f}, "
            "leaving too little float32 exp-range headroom for the "
            "iterate's residual: the f32 tiled SSY operator is likely to "
            "produce inf/NaN on this grid. Shrink the z / h_z axes "
            "(Rouwenhorst ladders span ±sqrt(n-1) sigma), use "
            "discretization='tauchen' (fixed ±3 sigma span at any point "
            "count), or the float64 eager chain.", stacklevel=2)
    sub_row = theta * (arrs["phi_l"][:, None] + arrs["phi_k"][None, :])
    sub_col = theta * (arrs["A0"] + arrs["phi_i"][:, None] + arrs["psi_ij"])
    ell0 = (arrs["A0"] + arrs["phi_l"][:, None, None, None]
            + arrs["phi_k"][None, :, None, None]
            + arrs["phi_i"][None, None, :, None]
            + arrs["psi_ij"][None, None, :, :])
    # Lazy form of the batched column factors: z_states = sigma_z[i] *
    # ladder[j], so psi_ij = A_z sigma_i lambda_j and both folded factors
    # are shared matrices with a scalar-scaled exponent correction,
    #     W[b] = exp(logW0 + t[b] * D)      (rank 1).
    sigma = disc.sigma_z_states.numpy()
    lam = disc.z_states.numpy()[0] / sigma[0]
    phi_i = arrs["phi_i"]
    Az_theta = theta * arrs["A_z"]
    lazy_c1 = (_log_probs(disc.h_z_Q)
               + theta * (phi_i[None, :] - phi_i[:, None]),
               (Az_theta * (sigma[None, :] - sigma[:, None]))[None],
               lam[None])
    lazy_c2 = (_log_probs(disc.z_P),
               (Az_theta * (lam[None, :] - lam[:, None]))[None],
               sigma[None])
    return TwoPhaseOperands(
        shapes=tuple(disc.shapes),
        W_r1=arrs["M1"], W_r2=arrs["M2"], W_c1=arrs["M3"], W_c2=arrs["M4"],
        add_row=sub_row + arrs["log_A2"][None, :],
        add_col=sub_col + arrs["log_A3"],
        theta=theta, beta=beta,
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0,
        lazy_c1=lazy_c1, lazy_c2=lazy_c2)


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


@spanned("sdfs.build.operands")
def two_phase_operands_gcy(model, disc, baseline: Optional[str] = None,
                           dense: bool = True) -> TwoPhaseOperands:
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

    ``baseline="loglinear"`` builds the normalized operand set
    (:func:`_two_phase_operands_gcy_normalized`; ``dense`` is read only
    there).
    """
    from .discrete_gcy import _gcy_factors, gcy_loglinear_column_span

    if baseline is not None:
        if baseline != "loglinear":
            raise ValueError(f"unknown baseline {baseline!r}")
        return _two_phase_operands_gcy_normalized(model, disc, dense=dense)
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
    span = gcy_loglinear_column_span(model, disc)
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


def _two_phase_operands_gcy_normalized(model, disc, dense: bool = True
                                       ) -> TwoPhaseOperands:
    """Baseline-normalized GCY operand set: the per-axis chain of
    ``discrete_gcy._T_gcy_normalized`` regrouped into the two-phase form.

    The log-linear baseline ell0 is a sum of row-separable terms (phi_d,
    phi_l: conjugated into the shared row factors), pure-column terms
    (A0, phi_c, phi_e: carried by sub_col/add_col and the shared part of
    the c2 factor) and a (c1, c2)-coupled part that is exactly rank-2
    separable over the grouping,

        g(p, q) = (A_z k_pi + A_zpi) sigma_zpi(e) ladpi(b)
                  + A_z sigma_z(c) zlad(a),
        p = (a, b) = (z, z_pi),  q = (c, e) = (h_z, h_zpi),

    because z_states = centers(e, b) + sigma_z(c) ladder(a).  The coupled
    part rides the column factors as diagonal conjugations, W_c1 batched
    over the next c2 index and W_c2 over the current c1 index, with rank-2
    lazy forms W[b] = exp(logW0 + t1[b] D1 + t2[b] D2).

    ``dense=False`` skips the (B, n, n) batched factors (host time and
    memory that grow as n_states^{4/3}, and entries that overflow float32
    on wide-Rouwenhorst grids): ``W_c1``/``W_c2`` are then broadcast
    placeholders and ``dense_placeholder`` is set, so only the lazy
    triples (:func:`conjugate_to_shared`, the streamed tier's entry) may
    be used.
    """
    import warnings

    from .discrete_gcy import _gcy_factors, gcy_loglinear_parts

    n_a, n_b, n_c, n_d, n_e, n_l = disc.shapes
    P, Q = n_a * n_b, n_c * n_e
    theta = float(model.theta)
    parts = gcy_loglinear_parts(model, disc)
    co = parts["co"]

    # Rank-2 coupled column baseline from the ladder structure.
    sigma_zpi = disc.sigma_zpi_states.numpy()                   # (e,)
    sigma_z = disc.sigma_z_states.numpy()                       # (c,)
    ladpi = disc.z_pi_states.numpy()[0] / sigma_zpi[0]
    kpi = model.rho_pi / (1.0 - model.rho)
    zst = disc.z_states.numpy()                                 # (b,c,e,a)
    c00 = kpi * sigma_zpi[0] * ladpi[0]
    zlad = (zst[0, 0, 0, :] - c00) / sigma_z[0]                 # (a,)
    u1 = np.broadcast_to(ladpi[None, :], (n_a, n_b)).reshape(P)
    u2 = np.broadcast_to(zlad[:, None], (n_a, n_b)).reshape(P)
    t1 = np.broadcast_to(
        ((co["A_z"] * kpi + co["A_zpi"]) * sigma_zpi)[None, :],
        (n_c, n_e)).reshape(Q)
    t2 = np.broadcast_to((co["A_z"] * sigma_z)[:, None],
                         (n_c, n_e)).reshape(Q)
    g = u1[:, None] * t1[None, :] + u2[:, None] * t2[None, :]   # (P, Q)
    # Check against the evaluated baseline psi_z + psi_pi as (P, Q); the
    # tolerance follows the grids' storage precision.
    psi_z_PQ = (co["A_z"] * zst).transpose(3, 0, 1, 2).reshape(P, Q)
    psi_pi_PQ = np.broadcast_to(
        (co["A_zpi"] * disc.z_pi_states.numpy()).T[None, :, None, :],
        (n_a, n_b, n_c, n_e)).reshape(P, Q)
    target = psi_z_PQ + psi_pi_PQ
    scale = max(1.0, float(np.max(np.abs(target))))
    eps = float(np.finfo(zst.dtype).eps)
    if np.max(np.abs(g - target)) > max(1e-9, 100.0 * eps) * scale:
        raise ValueError(
            "normalized GCY fold requires the separable z-ladder "
            "structure (z_states = centers(e, b) + sigma_z(c) * "
            "ladder(a)); this discretization does not match — use the "
            "per-axis chain (T_gcy_factory baseline='loglinear')")

    # Row factors: the per-axis-separable parts conjugate into the
    # shared matrices (h_c with phi_d; B_lam/h_lam with phi_l).
    phi_d, phi_l = parts["phi_d"], parts["phi_l"]
    B_lam, A2, A3 = (t.numpy() for t in _gcy_factors(model, disc))
    W_r1 = (disc.h_c_Q.numpy()
            * np.exp(theta * (phi_d[None, :] - phi_d[:, None])))
    W_r2 = B_lam * np.exp(theta * (phi_l[None, :] - phi_l[:, None]))

    with np.errstate(divide="ignore"):
        logWc1 = np.log(_kron(disc.z_P, disc.z_pi_P))            # (P, P')
        logWc2 = np.log(_kron(disc.h_z_Q, disc.h_zpi_Q))         # (Q, Q')
    phi_ce = (np.broadcast_to(parts["phi_c_"][:, None], (n_c, n_e))
              + parts["phi_e"][None, :]).reshape(Q)
    D1 = theta * (u1[None, :] - u1[:, None])                    # (P, P')
    D2 = theta * (u2[None, :] - u2[:, None])
    E1 = theta * (t1[None, :] - t1[:, None])                    # (Q, Q')
    E2 = theta * (t2[None, :] - t2[:, None])
    log0_c2 = logWc2 + theta * (phi_ce[None, :] - phi_ce[:, None])

    if dense:
        # One slice at a time into a preallocated buffer (the one-shot
        # broadcast is far slower in numpy at (256, 512, 512)).
        W_c1 = np.empty((Q, P, P), np.float64)
        for q in range(Q):
            np.multiply(D1, t1[q], out=W_c1[q])
            W_c1[q] += t2[q] * D2
            W_c1[q] += logWc1
        fac_max = float(W_c1.max())
        np.exp(W_c1, out=W_c1)
        W_c2 = np.empty((P, Q, Q), np.float64)
        for p in range(P):
            np.multiply(E1, u1[p], out=W_c2[p])
            W_c2[p] += u2[p] * E2
            W_c2[p] += log0_c2
        fac_max = max(fac_max, float(W_c2.max()))
        np.exp(W_c2, out=W_c2)
        if fac_max > 45.0:
            warnings.warn(
                f"normalized-operator folded factors reach "
                f"e^{fac_max:.0f}, beyond float32's exp-range headroom: "
                "the dense/lazy-batched f32 strip kernels and the f32 "
                "eager twin will produce inf/NaN on this grid.  The "
                "conjugated-shared streamed tier (engine='auto' routes "
                "there when it covers the set) carries the corrections in "
                "log space and stays finite; otherwise shrink the z / h_z "
                "axes, use discretization='tauchen', or the float64 "
                "eager chain.", stacklevel=3)
    else:
        W_c1 = np.broadcast_to(np.exp(logWc1)[None], (Q, P, P))
        W_c2 = np.broadcast_to(np.exp(log0_c2)[None], (P, Q, Q))

    # sub/add: theta * ell0 split over (rows, columns); add restores it
    # plus the true epilogue terms.
    E_col = co["A0"] + phi_ce[None, :] + g                      # (P, Q)
    sub_row = theta * (phi_d[:, None] + phi_l[None, :])         # (d, l)
    sub_col = theta * E_col
    add_row = (np.broadcast_to(np.log(A2)[:, None], (n_d, n_l)).copy()
               + sub_row)
    add_col = np.log(A3).reshape(P, Q) + sub_col
    ell0_view = np.transpose(parts["ell0"],
                             (3, 5, 0, 1, 2, 4)).reshape(n_d, n_l, P, Q)
    return TwoPhaseOperands(
        shapes=(n_d, n_l, P, Q),
        W_r1=W_r1, W_r2=W_r2, W_c1=W_c1, W_c2=W_c2,
        add_row=add_row, add_col=add_col,
        theta=theta, beta=float(model.beta),
        sub_row=sub_row, sub_col=sub_col, baseline_log_w=ell0_view,
        perm=(3, 5, 0, 1, 2, 4), inv_perm=(2, 3, 4, 0, 5, 1),
        state_shapes=tuple(disc.shapes),
        lazy_c1=(logWc1, np.stack([D1, D2]), np.stack([t1, t2])),
        lazy_c2=(log0_c2, np.stack([E1, E2]), np.stack([u1, u2])),
        dense_placeholder=not dense)


def _difference_split(D: np.ndarray, rtol: float = 1e-12):
    """``u`` with ``D[i, m] = u[m] - u[i]`` (any gauge: the constant
    cancels between the pre and post corrections), or None when ``D`` is
    not difference-separable."""
    u = np.asarray(D, np.float64)[0, :]
    resid = np.max(np.abs(D - (u[None, :] - u[:, None])))
    scale = max(1.0, float(np.max(np.abs(D))))
    return u if resid <= rtol * scale else None


def conjugate_to_shared(ops: TwoPhaseOperands
                        ) -> Optional[TwoPhaseOperands]:
    """Exact shared-factor form of a batched operand set whose lazy
    correction exponents are difference-separable.

    A batched factor ``W[b] = exp(log0 + sum_k t_k[b] D_k)`` with every
    ``D_k[x, x'] = u_k[x'] - u_k[x]`` is a diagonal conjugation of the
    shared ``W0 = exp(log0)``:

        W[b] = diag(e^{-g(., b)}) @ W0 @ diag(e^{g(., b)}),
        g(x, b) = sum_k u_k[x] t_k[b],

    so its log-space contraction is a pre-add of ``G``, the shared
    contraction and a post-subtract of ``G`` — elementwise adds that fold
    into ``sub_col`` (before c1), one ``mid_col`` term (between the
    contractions) and ``add_col`` (after c2).  The separable parts of
    ``mid_col`` move out of the stage boundary, so the normalized SSY and
    GCY sets come out mid-free.

    Returns ``ops`` itself when no factor is batched, and None when a
    batched factor has no difference-separable lazy form (e.g. the
    continuous-SSY quadrature P_z).
    """
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    G1 = G2 = None
    W_c1, W_c2 = ops.W_c1, ops.W_c2
    if ops.c1_batched:
        if ops.lazy_c1 is None:
            return None
        log0, D, t = ops.lazy_c1
        G1 = np.zeros((n_c1, n_c2), np.float64)
        for D_k, t_k in zip(np.asarray(D, np.float64),
                            np.asarray(t, np.float64)):
            u = _difference_split(D_k)
            if u is None:
                return None
            G1 = G1 + u[:, None] * t_k[None, :]               # (c1, c2)
        W_c1 = np.exp(np.asarray(log0, np.float64))
    if ops.c2_batched:
        if ops.is_pair or ops.lazy_c2 is None:
            return None
        log0, D, t = ops.lazy_c2
        G2 = np.zeros((n_c1, n_c2), np.float64)
        for D_k, t_k in zip(np.asarray(D, np.float64),
                            np.asarray(t, np.float64)):
            u = _difference_split(D_k)
            if u is None:
                return None
            G2 = G2 + t_k[:, None] * u[None, :]               # (c1, c2)
        W_c2 = np.exp(np.asarray(log0, np.float64))
    if G1 is None and G2 is None:
        return ops                      # already shared
    zero = np.zeros((n_c1, n_c2), np.float64)
    G1 = zero if G1 is None else G1
    G2 = zero if G2 is None else G2
    sub_col = (zero if ops.sub_col is None
               else np.asarray(ops.sub_col, np.float64)) - G1
    sub_row = (np.zeros((n_r1, n_r2), np.float64) if ops.sub_row is None
               else ops.sub_row)
    add_col = np.asarray(ops.add_col, np.float64) - G2
    mid = G2 - G1
    # A pure-c2 part h(q') of mid commutes with the c1 contraction (move
    # it before: sub_col), a pure-c1 part f(p) with the c2 contraction
    # (move it after: add_col).
    h_q = mid[0, :]
    f_p = mid[:, 0] - mid[0, 0]
    if np.allclose(mid, f_p[:, None] + h_q[None, :],
                   rtol=0.0, atol=1e-12 * max(1.0, np.max(np.abs(mid)))):
        sub_col = sub_col - h_q[None, :]
        add_col = add_col + f_p[:, None]
        mid = None
    elif np.max(np.abs(mid)) == 0.0:
        mid = None
    return dataclasses.replace(
        ops, W_c1=W_c1, W_c2=W_c2, sub_row=sub_row, sub_col=sub_col,
        mid_col=mid, add_col=add_col, lazy_c1=None, lazy_c2=None,
        dense_placeholder=False)


def make_eager_two_phase_T(ops: TwoPhaseOperands,
                           dtype: torch.dtype = torch.float32, *,
                           device="cuda") -> Callable:
    """Plain eager evaluator of a two-phase operand set: shared or batched
    column factors, with or without a folded baseline
    ``sub_row``/``sub_col`` and a ``mid_col`` correction, or a
    continuous-GCY pair set.

    The same math as the kernels with per-axis shifts at every
    contraction: their agreement oracle and their tangent (it is
    differentiable by ``torch.func``, and ``T.linearize(x)`` is Newton's
    tangent-linear at ``x``, ``ops/tangent.py``).  A batched c1 step
    contracts each next-c2 slice with its own factor,
    ``einsum("jim,tmj->tij")``, a batched c2 step each c1 slice,
    ``einsum("ijm,tim->tij")``, as in the JAX package's XLA twin.  A set
    built with ``dense=False`` (broadcast placeholders for its batched
    factors) raises ``ValueError``.  A pair set's c2 step takes one
    shift over the whole (B', J') slice, then contracts next-z_pi with
    P_zpi and next-z with P_z, as the JAX package's XLA twin does.
    float32 contractions run in full FP32: on a CUDA device it raises
    while TF32 matmuls are allowed
    (``torch.backends.cuda.matmul.allow_tf32``, off by default), whose
    10-bit mantissa misses the operator's 1e-6-class accuracy.

    A float32 set whose c1 and c2 factors are shared (2-D) and whose
    shapes the tangent passes cover records its whole chain on Newton's
    tape as one step (``kernels/tangent_two_phase.fused_chain``), which a
    CUDA vector runs as the tangent passes; a DTensor, a float64 twin,
    batched or pair factors and shapes with no passes record the stages
    one by one.
    """
    dev = resolve_device(device)
    column = eager_column_phase(ops, dtype, device=dev)
    n_r1, n_r2, n_c1, n_c2 = ops.shapes
    R, C = n_r1 * n_r2, n_c1 * n_c2
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    W_r1, W_r2 = map(cast, (ops.W_r1, ops.W_r2))
    # Field-sized sums of small float64 terms, formed on the device (the
    # host would form and copy them whole), then cast.
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    add = (f64(ops.add_row)[:, :, None]
           + f64(ops.add_col).reshape(-1)[None, None, :]).to(dtype)
    sub = None
    if ops.has_sub:
        sub = (f64(ops.sub_row).reshape(-1)[:, None, None]
               + f64(ops.sub_col)[None, :, :]).to(dtype)    # (R, c1, c2)
    theta, beta = float(ops.theta), float(ops.beta)
    shapes = tuple(ops.shapes)
    # Imported here: the kernels' modules import this one.
    from ..kernels.tangent_two_phase import fused_chain
    fused = fused_chain(ops, dtype, *column.weights, W_r1, W_r2)

    @linearizable
    def T(ell, tape=None):
        if tape is None or fused is None or is_dtensor(ell):
            return chain(ell, tape)
        steps = Tape()
        out = chain(ell, steps)
        tape.linear(fused(steps.finish()))
        return out

    def chain(ell, tape):
        check_full_fp32(ell)
        a = theta * viewed(ell, lambda t: t.to(dtype).reshape(R, n_c1, n_c2),
                           tape)
        if tape is not None:
            tape.scale(theta)
        if sub is not None:
            a = a - sub
        b = viewed(column(a, tape), lambda t: t.reshape(n_r1, n_r2, C), tape)
        b = lse_step(b, torch.amax(b, dim=0, keepdim=True),
                     lambda t: torch.einsum("lm,mkt->lkt", W_r1, t), tape)
        b = lse_step(b, torch.amax(b, dim=1, keepdim=True),
                     lambda t: torch.einsum("km,lmt->lkt", W_r2, t), tape)
        log_hwt = b + add
        out = log1p_epilogue(log_hwt, theta, beta, tape)
        return viewed(out, lambda t: t.reshape(shapes), tape)

    return T


def check_full_fp32(x: torch.Tensor) -> None:
    """Raise when float32 matmuls on ``x``'s CUDA device may run in TF32
    (the eager operators need full FP32)."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the eager two-phase operator needs full-FP32 "
                           "matmuls; set torch.backends.cuda.matmul."
                           "allow_tf32 = False")


def eager_column_phase(ops: TwoPhaseOperands,
                       dtype: torch.dtype = torch.float32, *,
                       device="cuda") -> Callable:
    """The column phase of :func:`make_eager_two_phase_T`: ``a`` (rows,
    n_c1, n_c2), theta*ell less the folded baseline, -> the c1
    contraction, ``mid_col`` and the c2 contraction, per field row (so
    any block of rows, such as one rank's shard, maps alone).
    ``column.weights`` is (W_c1, W_c2) on the device in ``dtype`` (W_c2
    None for a pair set)."""
    if ops.dense_placeholder:
        raise ValueError(
            "operand set was built with dense=False (batched column "
            "factors not materialized); conjugate_to_shared it for the "
            "streamed tier, or rebuild with dense=True")
    dev = resolve_device(device)
    n_c1, n_c2 = ops.shapes[2:]
    cast = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    W_c1 = cast(ops.W_c1)
    if ops.is_pair:
        P_z, P_zpi = map(cast, ops.pair_c2)      # (i, j, b, J), (y, b, B)
        n_i, n_y, n_b, n_j = ops.pair_shapes
    else:
        W_c2 = cast(ops.W_c2)
        c2_sub = "ijm,tim->tij" if ops.c2_batched else "jm,tim->tij"
    c1_sub = "jim,tmj->tij" if ops.c1_batched else "im,tmj->tij"
    mid = cast(ops.mid_col) if ops.has_mid else None

    def c2_pair(e):
        rows = e.shape[0]
        v = torch.einsum("ybB,tiyBJ->tiybJ", P_zpi,
                         e.reshape(rows, n_i, n_y, n_b, n_j))
        u = torch.einsum("ijbJ,tiybJ->tiybj", P_z, v)
        return u.reshape(rows, n_c1, n_c2)

    def column(a, tape=None):
        a = lse_step(a, torch.amax(a, dim=1, keepdim=True),
                     lambda t: torch.einsum(c1_sub, W_c1, t), tape)
        if mid is not None:
            a = a + mid
        return lse_step(a, torch.amax(a, dim=2, keepdim=True),
                        c2_pair if ops.is_pair
                        else lambda t: torch.einsum(c2_sub, W_c2, t), tape)

    column.weights = (W_c1, None if ops.is_pair else W_c2)
    return column
