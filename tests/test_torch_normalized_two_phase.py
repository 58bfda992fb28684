"""The port's baseline-normalized tiers (``baseline="loglinear"``) vs the
JAX package, on the CPU.

Host algebra (row normalization, operand sets, lazy triples, conjugated
sets) is float64 and must agree to 1e-12; the float64 normalized chains
to 1e-11, as the JAX package's own twin-vs-chain test holds them.  The
float32 deep-window contractions run torch's exp/log against the JAX
package's software transcendentals: 5e-6 on log-domain values near
log(800).  Streamed mid_col operators vs JAX's Pallas kernels in
interpret mode: 5e-6 (``test_torch_streamed_two_phase.py``).  Solves:
within 5e-5 of the JAX float64 solution, the port's float32 residual
bound.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import streamed_two_phase as jst
from sdfs_via_autodiff_tpu.operators import two_phase as jtp
from sdfs_via_autodiff_tpu.ops import contract as jct
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st
from sdfs_via_autodiff_tpu_torch.operators import two_phase as ptp
from sdfs_via_autodiff_tpu_torch.ops import contract as pct

SSY_SHAPES = ((4, 5, 6, 7), (6, 5, 6, 16))
GCY_SHAPES = (6, 5, 4, 3, 4, 3)
ATOL32 = 5e-6
SOLVE_ATOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module and its module-scoped fixtures
    (see ``test_torch_deferred_two_phase.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crossed(jops):
    """The port's operand set from a JAX set, attributes included."""
    d = dataclasses.asdict(jops)
    for a in ("perm", "inv_perm", "state_shapes", "lazy_c1", "lazy_c2",
              "dense_placeholder"):
        if hasattr(jops, a):
            d[a] = getattr(jops, a)
    return P.operands_from_numpy(d)


def _assert_sets_equal(pops, jops):
    for f in dataclasses.fields(jops):
        want, got = getattr(jops, f.name), getattr(pops, f.name)
        if want is None:
            assert got is None, f.name
        elif isinstance(want, (np.ndarray, jnp.ndarray)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12,
                                       atol=1e-12, err_msg=f.name)
        else:
            assert got == want, f.name
    for a in ("lazy_c1", "lazy_c2"):
        want = getattr(jops, a, None)
        if want is None:
            assert getattr(pops, a) is None, a
            continue
        for w, g in zip(want, getattr(pops, a)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                       atol=1e-12, err_msg=a)
    for a in ("perm", "inv_perm", "state_shapes"):
        if hasattr(jops, a):
            assert getattr(pops, a) == tuple(getattr(jops, a)), a
    assert pops.dense_placeholder == getattr(jops, "dense_placeholder",
                                             False)


def _ssy(shapes, method="rouwenhorst"):
    jm, pm = J.SSY(), P.SSY()
    return (jm, J.discretize_ssy(jm, shapes, method=method), pm,
            P.discretize_ssy(pm, shapes, method=method))


def _gcy(shapes, method="rouwenhorst"):
    jm, pm = J.GCY(), P.GCY()
    return (jm, J.discretize_gcy(jm, shapes, method=method), pm,
            P.discretize_gcy(pm, shapes, method=method))


@pytest.fixture(scope="module", params=["rouwenhorst", "tauchen"])
def gcy_sets(request):
    jm, jd, pm, pd = _gcy(GCY_SHAPES, request.param)
    jops = jtp.two_phase_operands_gcy(jm, jd, baseline="loglinear")
    pops = P.two_phase_operands_gcy(pm, pd, baseline="loglinear")
    return jm, jd, pm, pd, jops, pops


# ------------------------------------------------------------ ops/contract

def test_normalize_rows_log_matches_jax_including_the_nan_row():
    rng = np.random.default_rng(0)
    logM = 40.0 * rng.standard_normal((5, 3, 6))
    logM[2, 1, :] = -np.inf            # an all -inf row
    for subs, ax in (("kij,tkj->tki", 2), ("jim,tmj->tij", 1)):
        with np.errstate(invalid="ignore", divide="ignore"):
            want = jct.normalize_rows_log(logM, subs, ax)
            got = pct.normalize_rows_log(logM, subs, ax)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12,
                                       atol=1e-300)
    # The reference's defect, replicated: the all -inf row is NaN.
    assert np.isnan(got[0][2, 1]).all()


def _deep_case(step, seed=3):
    """A row-normalized factor and a float32 field whose corner rows sit
    up to 5*step below their slice max, so the deeper windows serve
    them."""
    rng = np.random.default_rng(seed)
    logM = np.log(rng.random((6, 6))) - 60.0 * np.abs(
        np.subtract.outer(np.arange(6), np.arange(6)))
    Mn, ls = jct.normalize_rows_log(logM, "im,tmj->tij", 1)
    v = (-step * np.arange(6)[None, :, None]
         + rng.standard_normal((3, 6, 4))).astype(np.float32)
    return np.asarray(Mn), np.asarray(ls), v


# Two windows of 80 reach ~167 nats below the slice max, three ~247.  A
# window of 100 has its exponents capped at 80 in both packages (the
# reference's defect, replicated), which drops terms but not these rows.
@pytest.mark.parametrize("passes,step,window", [(2, 30.0, 80.0),
                                                (3, 45.0, 80.0),
                                                (2, 30.0, 100.0)])
def test_deep_window_lse_and_its_jvp_match_jax(passes, step, window):
    Mn, _, v = _deep_case(step)
    dv = np.random.default_rng(4).standard_normal(v.shape).astype(np.float32)
    subs = "im,tmj->tij"
    jf = lambda x: jct.lse_matmul(jnp.asarray(Mn, jnp.float32), x, subs, 1,
                                  transcendentals="fast", deep_window=window,
                                  deep_passes=passes)
    pf = lambda x: pct.lse_matmul(torch.as_tensor(Mn, dtype=torch.float32),
                                  x, subs, 1, deep_window=window,
                                  deep_passes=passes)
    want, wt = jax.jvp(jf, (jnp.asarray(v),), (jnp.asarray(dv),))
    got, gt = torch.func.jvp(pf, (torch.as_tensor(v),),
                             (torch.as_tensor(dv),))
    want, wt = np.asarray(want), np.asarray(wt)
    # The single window flushes the deep rows; the deeper ones serve them.
    single = pct.lse_matmul(torch.as_tensor(Mn, dtype=torch.float32),
                            torch.as_tensor(v), subs, 1)
    assert not bool(torch.isfinite(single).all())
    assert np.isfinite(want).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATOL32 * scale)
    np.testing.assert_allclose(gt.numpy(), wt, rtol=1e-5, atol=1e-6)
    # _deep_passes alone, as JAX's.
    m = pct._deep_passes(torch.as_tensor(Mn, dtype=torch.float32),
                         torch.as_tensor(v), subs, 1, window, passes)
    jm = jct._deep_passes(jnp.asarray(Mn, jnp.float32), jnp.asarray(v),
                          subs, 1, jnp.exp, jnp.log, "highest", window,
                          passes)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0,
                               atol=ATOL32 * scale)


# --------------------------------------------------------------- chains

@pytest.mark.parametrize("shapes", SSY_SHAPES)
def test_normalized_ssy_chain_matches_jax(shapes):
    jm, jd, pm, pd = _ssy(shapes)
    ell = np.log(800.0) + 0.05 * np.random.default_rng(1).standard_normal(
        shapes)
    want = np.asarray(J.T_ssy_factory(jm, jd, space="log",
                                      baseline="loglinear")(jnp.asarray(ell)))
    T = P.T_ssy_factory(pm, pd, space="log", baseline="loglinear",
                        device="cpu")
    np.testing.assert_allclose(T(torch.as_tensor(ell)).numpy(), want,
                               rtol=1e-11, atol=0)
    T32 = P.T_ssy_factory(pm, pd, space="log", baseline="loglinear",
                          dtype=torch.float32, device="cpu")
    got32 = T32(torch.as_tensor(ell, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got32, want, rtol=0, atol=ATOL32)
    np.testing.assert_allclose(
        T.baseline_log_w.numpy(),
        np.asarray(J.T_ssy_factory(jm, jd, space="log",
                                   baseline="loglinear").baseline_log_w),
        rtol=1e-12)


def test_normalized_gcy_chain_matches_jax(gcy_sets):
    jm, jd, pm, pd, _, _ = gcy_sets
    ell = np.log(300.0) + 0.3 * np.random.default_rng(2).standard_normal(
        GCY_SHAPES)
    jT = J.T_gcy_factory(jm, jd, space="log", baseline="loglinear",
                         jit=False)
    want = np.asarray(jT(jnp.asarray(ell)))
    T = P.T_gcy_factory(pm, pd, space="log", baseline="loglinear",
                        device="cpu")
    np.testing.assert_allclose(T(torch.as_tensor(ell)).numpy(), want,
                               rtol=1e-11, atol=0)
    T32 = P.T_gcy_factory(pm, pd, space="log", baseline="loglinear",
                          dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(
        T32(torch.as_tensor(ell, dtype=torch.float32)).numpy(), want,
        rtol=0, atol=ATOL32)
    np.testing.assert_allclose(T.baseline_log_w.numpy(),
                               np.asarray(jT.baseline_log_w), rtol=1e-12)


def test_normalized_f32_chain_tangent_matches_jax():
    jm, jd, pm, pd = _ssy(SSY_SHAPES[0])
    rng = np.random.default_rng(5)
    ell = np.log(800.0) + 0.05 * rng.standard_normal(SSY_SHAPES[0])
    v = rng.standard_normal(SSY_SHAPES[0])
    jT = J.T_ssy_factory(jm, jd, space="log", baseline="loglinear",
                         dtype=jnp.float32, transcendentals="fast")
    _, want = jax.jvp(jT, (jnp.asarray(ell, jnp.float32),),
                      (jnp.asarray(v, jnp.float32),))
    pT = P.T_ssy_factory(pm, pd, space="log", baseline="loglinear",
                         dtype=torch.float32, device="cpu")
    _, got = torch.func.jvp(pT, (torch.as_tensor(ell, dtype=torch.float32),),
                            (torch.as_tensor(v, dtype=torch.float32),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------- operand sets

@pytest.mark.parametrize("shapes", SSY_SHAPES)
def test_normalized_ssy_operands_and_conjugation_match_jax(shapes):
    jm, jd, pm, pd = _ssy(shapes)
    jops = jtp.two_phase_operands_ssy(jm, jd, baseline="loglinear")
    pops = P.two_phase_operands_ssy(pm, pd, baseline="loglinear")
    assert pops.c1_batched and pops.c2_batched
    _assert_sets_equal(pops, jops)
    conj = P.conjugate_to_shared(pops)
    _assert_sets_equal(conj, jtp.conjugate_to_shared(jops))
    assert not (conj.c1_batched or conj.c2_batched or conj.has_mid)
    assert conj.lazy_c1 is None and conj.has_sub


def test_normalized_gcy_operands_and_conjugation_match_jax(gcy_sets):
    jm, jd, pm, pd, jops, pops = gcy_sets
    _assert_sets_equal(pops, jops)
    assert pops.lazy_c1[1].shape[0] == 2            # rank 2
    conj = P.conjugate_to_shared(pops)
    _assert_sets_equal(conj, jtp.conjugate_to_shared(jops))
    assert not (conj.c1_batched or conj.c2_batched or conj.has_mid)
    # dense=False: broadcast placeholders, the same lazy triples and the
    # same conjugated set.
    lean = P.two_phase_operands_gcy(pm, pd, baseline="loglinear",
                                    dense=False)
    _assert_sets_equal(lean, jtp.two_phase_operands_gcy(
        jm, jd, baseline="loglinear", dense=False))
    _assert_sets_equal(P.conjugate_to_shared(lean), conj)


def test_lazy_triples_rebuild_the_dense_factors(gcy_sets):
    pops = gcy_sets[-1]
    for lazy, W in ((pops.lazy_c1, pops.W_c1), (pops.lazy_c2, pops.W_c2)):
        log0, D, t = lazy
        dense = np.exp(log0[None] + np.einsum("kb,kxy->bxy", t, D))
        np.testing.assert_allclose(dense, W, rtol=1e-12)


def test_difference_split_and_unconjugable_sets():
    u = np.array([0.5, -1.0, 2.0])
    D = u[None, :] - u[:, None]
    np.testing.assert_allclose(ptp._difference_split(D) - u,
                               np.full(3, -u[0]), atol=1e-15)
    assert ptp._difference_split(D + np.eye(3)) is None
    np.testing.assert_array_equal(jtp._difference_split(D + np.eye(3)),
                                  None)
    # Continuous SSY's P_z has no lazy form: not conjugable, as in JAX.
    grids = P.build_grid_ssy(P.SSY(), 3, 3, 3, 4)
    ops = P.two_phase_operands_ssy_continuous(P.SSY(), grids)
    assert P.conjugate_to_shared(ops) is None
    plain = P.two_phase_operands_ssy(P.SSY(), P.discretize_ssy(
        P.SSY(), (3, 3, 3, 4)))
    assert P.conjugate_to_shared(plain) is plain


# ------------------------------------------------------------ eager twin

def _mid_sets(shapes=(4, 8, 6, 64), seed=7):
    """Conjugated normalized SSY sets (JAX, port) plus the same seeded
    non-separable mid_col."""
    jm, jd, pm, pd = _ssy(shapes)
    jconj = jtp.conjugate_to_shared(
        jtp.two_phase_operands_ssy(jm, jd, baseline="loglinear"))
    mid = 0.05 * np.random.default_rng(seed).standard_normal(shapes[2:])
    jmid = dataclasses.replace(jconj, mid_col=mid)
    return jmid, _crossed(jmid)


@pytest.mark.parametrize("which", ["batched", "conjugated", "mid_col"])
def test_twin_matches_jax_xla_twin(gcy_sets, which):
    if which == "mid_col":
        jops, pops = _mid_sets()
    else:
        jops, pops = gcy_sets[-2], gcy_sets[-1]
        if which == "conjugated":
            jops = jtp.conjugate_to_shared(jops)
            pops = P.conjugate_to_shared(pops)
    ell = np.asarray(jops.baseline_log_w) + 0.05 * np.random.default_rng(
        8).standard_normal(jops.shapes)
    want = np.asarray(jtp.make_xla_two_phase_T(jops, jnp.float64)(
        jnp.asarray(ell)))
    got = P.make_eager_two_phase_T(pops, torch.float64, device="cpu")(
        torch.as_tensor(ell)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_twin_rejects_dense_placeholder_sets(gcy_sets):
    pm, pd = gcy_sets[2], gcy_sets[3]
    lean = P.two_phase_operands_gcy(pm, pd, baseline="loglinear",
                                    dense=False)
    with pytest.raises(ValueError, match="dense=False"):
        P.make_eager_two_phase_T(lean, device="cpu")


# -------------------------------------------------------- streamed tier

def test_mid_col_operator_matches_jax_streamed_kernels():
    jops, pops = _mid_sets()
    ell = (np.asarray(jops.baseline_log_w) + 0.02 * np.random.default_rng(
        9).standard_normal(jops.shapes)).astype(np.float32)
    jT = jst.make_streamed_T_log(jops, precision="highest", interpret=True)
    want = np.asarray(jT(jnp.asarray(ell)))
    T = P.make_streamed_T_log(pops, device="cpu")
    assert (T.engine, T.mode) == ("streamed", "lse")
    got = T(torch.as_tensor(ell)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)
    with pytest.raises(ValueError, match="LSE only"):
        P.make_streamed_T_log(pops, mode="fast", device="cpu")


def test_pass_b_plain_adds_mid_col_between_the_contractions():
    _, pops = _mid_sets()
    L, K, I, J_ = pops.shapes
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).float()
    ell = t(pops.baseline_log_w).reshape(L * K, I, J_)
    args = (t(pops.W_c1), t(np.asarray(pops.W_c2).T), float(pops.theta),
            "lse", t(np.asarray(pops.sub_row).reshape(L * K)),
            t(pops.sub_col))
    c1 = st.pass_b_plain(ell, args[0], None, *args[2:])
    want = st.pass_b_plain(ell, *args)
    # The same result from the c1-only branch with mid_col added by hand,
    # then the c2 step.
    a = c1 + t(pops.mid_col)
    m = torch.amax(a, dim=2, keepdim=True)
    by_hand = m + torch.log(torch.matmul(torch.exp(a - m), args[1]))
    got = st.pass_b_plain(ell, *args, mid_col=t(pops.mid_col))
    assert float((got - by_hand).abs().max()) == 0.0
    assert float((got - want).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="lse mode"):
        st.pass_b(ell, args[0], args[1], args[2], "fast",
                  mid_col=t(pops.mid_col))


def test_deferred_configuration_admits_a_folded_baseline(gcy_sets):
    # Fault 1: the port refused a folded baseline on the deferred
    # configuration, which JAX's _streamed_config admits (the conjugated
    # normalized GCY set at the 25.2M grid needs it).
    pops = P.conjugate_to_shared(gcy_sets[-1])
    big = dataclasses.replace(
        pops, shapes=(12, 16, 512, 256), W_r1=np.eye(12), W_r2=np.eye(16),
        W_c1=np.eye(512), W_c2=np.eye(256), add_row=np.zeros((12, 16)),
        add_col=np.zeros((512, 256)), sub_row=np.zeros((12, 16)),
        sub_col=np.zeros((512, 256)), baseline_log_w=None)
    assert P.streamed_config(big) == "deferred"
    assert P.tiled_engine(big)[0] == "streamed"
    with_mid = dataclasses.replace(big, mid_col=np.zeros((512, 256)))
    assert P.streamed_config(with_mid) is None


def test_conjugated_operator_runs_streamed_and_matches_f64(gcy_sets):
    _, _, pm, pd, _, pops = gcy_sets
    T = P.make_tiled_T_log_gcy(pm, pd, baseline="loglinear", device="cpu")
    assert T.engine.startswith("streamed") and T.mode == "lse"
    ell = T.baseline_log_w.double() + 0.05
    want = P.T_gcy_factory(pm, pd, space="log", device="cpu")(ell)
    got = T(ell.float()).double()
    assert float((got - want).abs().max()) <= ATOL32
    # The twin is the conjugated (shared) set's, so the tangent keeps
    # shared factors; it agrees with the f64 chain's tangent.
    v = torch.ones_like(ell)
    _, dT = torch.func.jvp(T, (ell.float(),), (v.float(),))
    _, d64 = torch.func.jvp(P.T_gcy_factory(pm, pd, space="log",
                                            device="cpu"), (ell,), (v,))
    assert float((dT.double() - d64).abs().max()) <= 1e-4


# ------------------------------------------------------------- warnings

def _messages(build, needle):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        build()
    return [str(w.message) for w in caught if needle in str(w.message)]


def test_folded_factor_warning_matches_jax():
    jm, jd, pm, pd = _ssy((2, 2, 56, 64))
    got = _messages(lambda: P.two_phase_operands_ssy(pm, pd, "loglinear"),
                    "folded factors reach")
    want = _messages(lambda: jtp.two_phase_operands_ssy(jm, jd, "loglinear"),
                     "folded factors reach")
    assert len(got) == len(want) == 1
    assert got[0].split(",")[0] == want[0].split(",")[0]   # "... e^65"
    jm, jd, pm, pd = _ssy(SSY_SHAPES[1])
    assert not _messages(lambda: P.two_phase_operands_ssy(pm, pd,
                                                          "loglinear"),
                         "folded factors reach")


def test_conjugated_floor_warning_matches_jax():
    jm, jd, pm, pd = _gcy((32, 8, 16, 2, 8, 2))
    pconj = P.conjugate_to_shared(P.two_phase_operands_gcy(
        pm, pd, "loglinear", dense=False))
    jconj = jtp.conjugate_to_shared(jtp.two_phase_operands_gcy(
        jm, jd, "loglinear", dense=False))
    got = _messages(lambda: st._warn_conjugated_f32_floor(pconj),
                    "flush to zero")
    want = _messages(lambda: jst._warn_conjugated_f32_floor(jconj),
                     "flush to zero")
    assert len(got) == len(want) == 1
    assert got[0].split(":")[0] == want[0].split(":")[0]    # "... e^-182"
    assert not _messages(lambda: st._warn_conjugated_f32_floor(
        P.conjugate_to_shared(P.two_phase_operands_gcy(
            P.GCY(), P.discretize_gcy(P.GCY(), GCY_SHAPES), "loglinear"))),
        "flush to zero")


# --------------------------------------------------------------- drivers

@pytest.mark.parametrize("name,shapes,tol", [
    ("ssy", (4, 5, 6, 7), 2e-5), ("gcy", (4, 3, 3, 2, 3, 2), 3.04e-5)])
@pytest.mark.parametrize("kernel", ["xla", "tiled"])
def test_driver_loglinear_matches_jax_f64_solve(name, shapes, tol, kernel):
    jm, pm = (J.SSY(), P.SSY()) if name == "ssy" else (J.GCY(), P.GCY())
    want = np.log(np.asarray(J.wc_ratio_discrete(
        jm, shapes, tol=1e-11, baseline="loglinear").w_star))
    got = P.wc_ratio_discrete(pm, shapes, kernel=kernel,
                              baseline="loglinear", device="cpu",
                              tol=tol if kernel == "tiled" else 1e-10)
    assert got.converged
    assert got.w_star.dtype == (torch.float32 if kernel == "tiled"
                                else torch.float64)
    np.testing.assert_allclose(torch.log(got.w_star.double()).numpy(), want,
                               rtol=0, atol=SOLVE_ATOL)


def test_engine_and_lazy_bytes_are_tier_options():
    # Fault 2: the port rejected engine and lazy_bytes as TPU-only
    # options; they pick a tier and a factor form.
    m = P.SSY()
    d = P.discretize_ssy(m, SSY_SHAPES[1])
    T = P.make_tiled_T_log_ssy(m, d, baseline="loglinear", engine="strip",
                               lazy_bytes=0, device="cpu")
    assert (T.engine, T.mode, T.lazy) == ("strip", "lse", (True, True))
    assert "engine" not in P.kernels.tiled_two_phase.TPU_ONLY_OPTIONS
    for option in ("strip_bytes", "precision", "transcendentals",
                   "twin_precision", "interpret"):
        with pytest.raises(ValueError, match="TPU-only"):
            P.make_tiled_T_log_ssy(m, d, device="cpu", **{option: None})
