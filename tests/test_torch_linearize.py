"""Newton's hand-written tangent-linear (``ops/tangent.py``) on the CPU.

Every LSE-chain operator on a Newton path gives ``T.linearize(x)``: its
primal runs once with a tape and each matvec replays the stored factors.
Per operator, on the same inputs made from numpy seeds:

* float64: the port's ``linearize(x)(v)`` within 1e-12 relative (sup
  norm) of ``torch.func.jvp`` of the same operator, and within 1e-10 of
  ``jax.linearize`` of its JAX counterpart (the XLA twin of a two-phase
  or fused set, the factory itself for the per-axis operators);
* float32: within 2e-6 of the ``jvp`` matvec relative to the sup of
  ``v``, and no farther from the float64 linearization than the ``jvp``
  matvec is (to 25%).  J is nonnegative with rows summing to at most 1,
  so either route's rounding is a few ulps of ``J |v|`` <= ``|v|``; the
  matvec ``(J - I) v`` itself cancels where J is close to I (the small
  GCY and Tauchen sets: a tenth of ``v`` and less), and ``J v`` where J
  averages v away (the deferred set), so neither is the scale.

A torch-function mode that counts exp and log calls shows that a
matvec runs none of them and that a Newton solve runs the twin's primal
once per Newton step; float64 Newton solves on the new route meet JAX's
``newton_solver`` fixed points within 1e-10.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import fused_discrete as jfd
from sdfs_via_autodiff_tpu.operators import degroot as JD
from sdfs_via_autodiff_tpu.operators import two_phase as jtp
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy as jax_grid_ssy
from sdfs_via_autodiff_tpu_torch.kernels import fused_discrete as fd
from sdfs_via_autodiff_tpu_torch.operators import degroot as PD
from sdfs_via_autodiff_tpu_torch.ops.tangent import Linearization
from sdfs_via_autodiff_tpu_torch.solvers.sharding import tangent_matvec
from sdfs_via_autodiff_tpu_torch.utils.profiling import recorded

JVP_RTOL64 = 1e-12
JAX_RTOL64 = 1e-10
JVP_RTOL32 = 2e-6
SOLVE_ATOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_v(got, want, v) -> float:
    """sup |got - want| / sup |v|: float32 matvecs' rounding scale."""
    return float((got - want).abs().max() / v.abs().max())


def _near(base, seed, scale=0.05):
    base = np.asarray(base, np.float64)
    return base + scale * np.random.default_rng(seed).standard_normal(
        base.shape)


def _crossed(jops):
    """The port's operand set from a JAX set, attributes included."""
    d = dataclasses.asdict(jops)
    for a in ("perm", "inv_perm", "state_shapes", "pair_c2", "pair_shapes",
              "lazy_c1", "lazy_c2", "dense_placeholder"):
        if hasattr(jops, a):
            d[a] = getattr(jops, a)
    return P.operands_from_numpy(d)


def _two_phase(jops, x):
    """(port operator in a dtype, JAX f64 twin, x) of a two-phase set."""
    pops = _crossed(jops)
    return (lambda dt: P.make_eager_two_phase_T(pops, dt, device="cpu"),
            jtp.make_xla_two_phase_T(jops, jnp.float64), x)


def _ssy_disc(shapes, method="rouwenhorst"):
    return (J.discretize_ssy(J.SSY(), shapes, method=method),
            P.discretize_ssy(P.SSY(), shapes, method=method))


def _gcy_disc(shapes):
    return (J.discretize_gcy(J.GCY(), shapes, method="tauchen"),
            P.discretize_gcy(P.GCY(), shapes, method="tauchen"))


def _case(name):
    """(port operator factory dtype -> T, JAX float64 operator, x)."""
    if name == "ssy_plain":
        jd, _ = _ssy_disc((4, 4, 4, 6))
        return _two_phase(jtp.two_phase_operands_ssy(J.SSY(), jd),
                          _near(np.full((4, 4, 4, 6), np.log(800.0)), 1))
    if name == "gcy_view":
        jd, _ = _gcy_disc((4, 3, 3, 2, 3, 2))
        jops = jtp.two_phase_operands_gcy(J.GCY(), jd)
        return _two_phase(jops, _near(np.full(jops.shapes, np.log(300.0)),
                                      2, 0.1))
    if name == "ssy_continuous_batched":
        jg = jax_grid_ssy(J.SSY(), 4, 5, 4, 8)
        jops = jtp.two_phase_operands_ssy_continuous(J.SSY(), jg, 3)
        return _two_phase(jops, _near(np.full(jops.shapes, np.log(700.0)),
                                      3, 0.02))
    if name == "conjugated_sub_mid":
        jd, _ = _ssy_disc((4, 8, 6, 16))
        jconj = jtp.conjugate_to_shared(jtp.two_phase_operands_ssy(
            J.SSY(), jd, baseline="loglinear"))
        mid = 0.05 * np.random.default_rng(7).standard_normal((6, 16))
        jops = dataclasses.replace(jconj, mid_col=mid)
        return _two_phase(jops, _near(jops.baseline_log_w, 4))
    if name == "pair":
        jg = jax_grid_gcy(J.GCY(), 4, 3, 2, 2, 6, 2)
        jops = jtp.two_phase_operands_gcy_continuous(J.GCY(), jg, 3,
                                                     "loglinear")
        return _two_phase(jops, _near(jops.baseline_log_w, 5, 0.02))
    if name == "fused_kron":
        jd, pd = _ssy_disc((4, 4, 4, 6))
        jo = jfd.kron_operands_ssy(J.SSY(), jd, jnp.float64)
        po = fd.kron_operands_ssy(P.SSY(), pd, torch.float64)
        args = (J.SSY().theta, J.SSY().beta, (4, 4, 4, 6), 16, 24)
        return (lambda dt: fd.make_xla_T_from_operands(
                    *po, *args, dtype=dt, device="cpu"),
                jfd.make_xla_T_from_operands(*jo, *args, dtype=jnp.float64),
                _near(np.full((4, 4, 4, 6), np.log(800.0)), 6))
    if name == "fused_kron_sub":
        sizes = (4, 3, 3, 3, 4, 3)
        jg = jax_grid_gcy(J.GCY(), *sizes)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        M1, M2T, kap, shapes, rows, cols, sub = \
            jfd.kron_operands_gcy_continuous(J.GCY(), jg, 5, "loglinear",
                                             dtype=jnp.float64)
        pM1, pM2T, pkap, _, _, _, psub = P.kron_operands_gcy_continuous(
            P.GCY(), pg, 5, "loglinear", dtype=torch.float64)
        th, be = J.GCY().theta, J.GCY().beta
        jT = jfd.make_xla_T_from_operands(M1, M2T, kap, th, be, shapes,
                                          rows, cols, dtype=jnp.float64)
        # JAX's function has no sub: theta*ell - sub = theta*(ell - sub/theta).
        shift = np.asarray(sub).reshape(shapes) / th
        return (lambda dt: fd.make_xla_T_from_operands(
                    pM1, pM2T, pkap, th, be, shapes, rows, cols, dtype=dt,
                    sub=psub, device="cpu"),
                lambda ell: jT(ell - shift),
                _near(shift, 7, 0.02))
    if name == "T_ssy_factory":
        jd, pd = _ssy_disc((4, 4, 4, 6))
        return (lambda dt: P.T_ssy_factory(P.SSY(), pd, space="log",
                                           dtype=dt, device="cpu"),
                J.T_ssy_factory(J.SSY(), jd, space="log"),
                _near(np.full((4, 4, 4, 6), np.log(800.0)), 8))
    if name == "T_ssy_factory_normalized":
        jd, pd = _ssy_disc((4, 4, 4, 6))
        jT = J.T_ssy_factory(J.SSY(), jd, space="log", baseline="loglinear")
        return (lambda dt: P.T_ssy_factory(
                    P.SSY(), pd, space="log", baseline="loglinear",
                    dtype=dt, device="cpu"),
                jT, _near(jT.baseline_log_w, 9))
    if name == "T_gcy_factory":
        jd, pd = _gcy_disc((4, 3, 3, 2, 3, 2))
        return (lambda dt: P.T_gcy_factory(P.GCY(), pd, space="log",
                                           dtype=dt, device="cpu"),
                J.T_gcy_factory(J.GCY(), jd, space="log"),
                _near(np.full((4, 3, 3, 2, 3, 2), np.log(300.0)), 10, 0.1))
    if name == "continuous_ssy":
        jg = jax_grid_ssy(J.SSY(), 4, 4, 4, 5)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        return (lambda dt: P.T_ssy_continuous_factory(
                    P.SSY(), pg, space="log", dtype=dt, device="cpu"),
                J.T_ssy_continuous_factory(J.SSY(), jg, space="log"),
                _near(np.full((4, 4, 4, 5), np.log(700.0)), 11))
    if name == "continuous_gcy":
        sizes = (3, 3, 3, 3, 4, 3)
        jg = jax_grid_gcy(J.GCY(), *sizes)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        jT = J.T_gcy_continuous_factory(J.GCY(), jg, space="log",
                                        baseline="loglinear", jit=False)
        return (lambda dt: P.T_gcy_continuous_factory(
                    P.GCY(), pg, space="log", baseline="loglinear",
                    dtype=dt, device="cpu"),
                jT, _near(jT.baseline_log_w, 12, 0.02))
    assert name == "degroot"
    jd, pd = _ssy_disc((4, 3, 5, 6))
    g = np.exp(np.random.default_rng(13).standard_normal((4, 3, 5, 6)))
    return (lambda dt: PD.T_degroot_factory(P.SSY(), pd, space="log",
                                            dtype=dt, device="cpu"),
            JD.T_degroot_factory(J.SSY(), jd, space="log"),
            np.log(g * 1e-3))


CASES = ["ssy_plain", "gcy_view", "ssy_continuous_batched",
         "conjugated_sub_mid", "pair", "fused_kron", "fused_kron_sub",
         "T_ssy_factory", "T_ssy_factory_normalized", "T_gcy_factory",
         "continuous_ssy", "continuous_gcy", "degroot"]


def _jvp_matvec(T, x, v):
    return torch.func.jvp(lambda y: T(y) - y, (x,), (v,))[1]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    make, jT, x = _case(request.param)
    v = np.random.default_rng(99).standard_normal(x.shape)
    return request.param, make, jT, x, v


def test_float64_linearization_is_the_jvp(case):
    _, make, _, x, v = case
    T = make(torch.float64)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    lin = T.linearize(xt)
    assert isinstance(lin, Linearization)
    got = lin(vt)
    assert _rel(got, _jvp_matvec(T, xt, vt)) <= JVP_RTOL64
    # A second matvec replays the same factors.
    assert torch.equal(lin(vt), got)


def test_float64_linearization_matches_jax_linearize(case):
    _, make, jT, x, v = case
    T = make(torch.float64)
    got = T.linearize(torch.as_tensor(x))(torch.as_tensor(v))
    _, f = jax.linearize(lambda y: jT(y) - y, jnp.asarray(x))
    assert _rel(got, f(jnp.asarray(v))) <= JAX_RTOL64


def test_float32_linearization_is_the_jvp(case):
    _, make, _, x, v = case
    T = make(torch.float32)
    xt, vt = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(
        v, dtype=torch.float32)
    got = T.linearize(xt)(vt)
    assert got.dtype == torch.float32
    want = _jvp_matvec(T, xt, vt)
    assert _rel_v(got, want, vt) <= JVP_RTOL32
    T64 = make(torch.float64)
    ref = T64.linearize(xt.double())(vt.double())
    assert _rel(got, ref) <= 1.25 * _rel(want, ref)


# --------------------------------------------- every tier reaches Newton

def _tiled(name):
    """A tiled operator on the CPU (the kernels' plain versions) of each
    tier and mode ``tiled_engine`` picks, its engine and a field near
    its iterates."""
    ssy = lambda shapes: np.full(shapes, np.log(800.0))
    if name in ("streamed_full", "streamed_full_lse"):
        _, pd = _ssy_disc((4, 4, 4, 6))
        mode = "lse" if name == "streamed_full_lse" else "auto"
        return (P.make_tiled_T_log_ssy(P.SSY(), pd, mode=mode, device="cpu"),
                "streamed", ssy((4, 4, 4, 6)))
    if name == "deferred":
        _, pd = _ssy_disc((2, 2, 64, 512), "tauchen")
        return (P.make_tiled_T_log_ssy(P.SSY(), pd, device="cpu"),
                "streamed-deferred", ssy((2, 2, 64, 512)))
    if name == "batched":
        pg = P.build_grid_ssy(P.SSY(), 4, 5, 4, 8)
        return (P.make_tiled_T_log_ssy_continuous(P.SSY(), pg, 3,
                                                  device="cpu"),
                "streamed", np.full((4, 5, 4, 8), np.log(700.0)))
    if name == "pair":
        jg = jax_grid_gcy(J.GCY(), 8, 3, 2, 4, 128, 2)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        T = P.make_tiled_T_log_gcy_continuous(P.GCY(), pg, 5,
                                              baseline="loglinear",
                                              device="cpu")
        return T, "streamed-pair", T.baseline_log_w.numpy()
    if name == "gcy_natural":
        _, pd = _gcy_disc((4, 3, 3, 2, 3, 2))
        return (P.make_tiled_T_log_gcy(P.GCY(), pd, device="cpu"),
                "streamed", np.full((4, 3, 3, 2, 3, 2), np.log(300.0)))
    _, pd = _ssy_disc((4, 4, 4, 6), "tauchen")
    baseline = None if name == "strip" else "loglinear"
    engine = "strip" if name.startswith("strip") else "auto"
    T = P.make_tiled_T_log_ssy(P.SSY(), pd, baseline=baseline,
                               engine=engine, device="cpu")
    base = ssy((4, 4, 4, 6)) if baseline is None else (
        T.baseline_log_w.numpy())
    return T, "strip" if engine == "strip" else "streamed", base


TIERS = ["streamed_full", "streamed_full_lse", "normalized_conjugated",
         "deferred", "batched", "pair", "gcy_natural", "strip",
         "strip_normalized"]


@pytest.mark.parametrize("tier", TIERS)
def test_every_tier_linearizes_its_twin(tier):
    T, engine, base = _tiled(tier)
    assert T.engine == engine
    x = torch.as_tensor(_near(base, 14, 0.02), dtype=torch.float32)
    v = torch.as_tensor(np.random.default_rng(15).standard_normal(
        base.shape), dtype=torch.float32)
    mv = tangent_matvec(T.twin, x)
    assert isinstance(mv, Linearization)
    assert _rel_v(mv(v), _jvp_matvec(T, x, v), v) <= JVP_RTOL32


# ------------------------------------------- counts and the Newton route

class _Count(TorchFunctionMode):
    """Counts the transcendental torch calls (exp, log, log1p, expm1),
    except while ``paused``."""

    NAMES = {"exp", "log", "log1p", "expm1"}

    def __init__(self):
        super().__init__()
        self.n = Counter()
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if not self.paused and name in self.NAMES:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _builds_once_a_step(T, x, v) -> Counter:
    """Checks that ``T.twin``'s linearization builds on its first matvec
    only, that a matvec runs no transcendental and that a Newton solve
    through ``T`` (its primal not counted) runs the twin's primal once per
    Newton step; returns the transcendentals of one primal."""
    from sdfs_via_autodiff_tpu_torch.solvers.fixed_point import newton_solver
    count = _Count()
    with count:
        lin = tangent_matvec(T.twin, x)
    assert isinstance(lin, Linearization)
    assert not count.n                 # built on the first matvec only
    with count:
        lin.build()
    per_primal = Counter(count.n)
    count.n.clear()
    with count:
        lin(v)
        lin(v)
    assert not count.n, count.n        # a matvec: contractions and products

    def T_kernels(y):                  # the kernels' primal, not counted
        count.paused = True
        try:
            return T(y)
        finally:
            count.paused = False
    T_kernels.twin = T.twin
    with count, recorded() as recs:
        res = newton_solver(T_kernels, x, tol=2e-5)
    assert res.converged, res
    steps = sum(1 for r in recs if r.name == "sdfs.krylov" and r.count > 0)
    assert steps >= 2
    assert count.n == Counter({k: steps * n for k, n in per_primal.items()})
    return per_primal


def test_matvecs_run_no_transcendental_and_newton_builds_once_a_step():
    _, pd = _ssy_disc((4, 4, 4, 6))
    T = P.make_tiled_T_log_ssy(P.SSY(), pd, device="cpu")
    x = torch.full((4, 4, 4, 6), float(np.log(800.0)))
    v = torch.as_tensor(np.random.default_rng(16).standard_normal(
        (4, 4, 4, 6)), dtype=torch.float32)
    per_primal = _builds_once_a_step(T, x, v)
    assert per_primal["exp"] == 5 and per_primal["log"] == 4


@pytest.mark.parametrize("interp", ["post", "loglin"])
def test_post_interp_kernel_matvecs_run_no_transcendental_and_newton_builds_once_a_step(interp):
    """The B8 operator on the CPU (its plain version): Newton's tangent
    is its float32 node-chain twin's linearization."""
    sizes = (3, 3, 3, 4)
    T = P.make_post_interp_kernel_T_ssy(P.SSY(), P.build_grid_ssy(
        P.SSY(), *sizes), 2, interp, device="cpu")
    x = torch.full(sizes, float(np.log(700.0)))
    v = torch.as_tensor(np.random.default_rng(17).standard_normal(sizes),
                        dtype=torch.float32)
    per_primal = _builds_once_a_step(T, x, v)
    assert per_primal["exp"] >= 1 and per_primal["log1p"] == 1


@pytest.mark.parametrize("model", ["ssy", "gcy"])
def test_newton_meets_jax_fixed_point(model):
    """The driver's float64 Newton solve (the per-axis log operator, which
    linearizes by its tape) against JAX's."""
    if model == "ssy":
        jm, pm, shapes = J.SSY(), P.SSY(), (4, 4, 4, 6)
        T = P.T_ssy_factory(pm, P.discretize_ssy(pm, shapes), space="log",
                            device="cpu")
    else:
        jm, pm, shapes = J.GCY(), P.GCY(), (3, 3, 3, 2, 3, 2)
        T = P.T_gcy_factory(pm, P.discretize_gcy(pm, shapes), space="log",
                            device="cpu")
    assert isinstance(tangent_matvec(T, torch.zeros(shapes,
                                                    dtype=torch.float64)),
                      Linearization)
    want = J.wc_ratio_discrete(jm, shapes, tol=1e-12)
    got = P.wc_ratio_discrete(pm, shapes, tol=1e-12, device="cpu")
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)),
                               rtol=0, atol=SOLVE_ATOL)


def _kept_on_jvp(name):
    """Operators whose tangent stays a ``torch.func.jvp`` per matvec
    (w space), and those that left that route (their own
    linearization)."""
    if name == "node_chain":
        pg = P.build_grid_ssy(P.SSY(), 4, 4, 4, 5)
        return P.T_ssy_continuous_factory(P.SSY(), pg, interp="post",
                                          space="log", dtype=torch.float32,
                                          device="cpu")
    if name == "deep_window_f32":
        _, pd = _ssy_disc((4, 4, 4, 6))
        return P.T_ssy_factory(P.SSY(), pd, space="log",
                               baseline="loglinear", dtype=torch.float32,
                               device="cpu")
    _, pd = _ssy_disc((4, 4, 4, 6))
    return P.T_ssy_factory(P.SSY(), pd, space="w", device="cpu")


@pytest.mark.parametrize("name", ["w_space"])
def test_operators_left_on_the_jvp_matvec(name):
    T = _kept_on_jvp(name)
    assert not hasattr(getattr(T, "twin", T), "linearize")
    x = torch.exp(torch.full((4, 4, 4, 6), float(np.log(800.0)),
                             dtype=torch.float64))
    v = torch.ones_like(x)
    np.testing.assert_array_equal(tangent_matvec(T, x)(v).numpy(),
                                  _jvp_matvec(T, x, v).numpy())


@pytest.mark.parametrize("name", ["node_chain", "deep_window_f32"])
def test_operators_taken_off_the_jvp_matvec(name):
    # The float32 node chain and the float32 deep windows, on the
    # jvp route until their linearization: it is theirs now, and its
    # matvec is the jvp's to float32 rounding.
    T = _kept_on_jvp(name)
    assert hasattr(T, "linearize")
    shape = (4, 4, 4, 5) if name == "node_chain" else (4, 4, 4, 6)
    x = torch.full(shape, float(np.log(800.0)))
    if name == "deep_window_f32":
        x = T.baseline_log_w.clone()
    v = torch.ones_like(x)
    mv = tangent_matvec(T, x)
    assert isinstance(mv, Linearization)
    assert _rel_v(mv(v), _jvp_matvec(T, x, v), v) <= JVP_RTOL32


# ---------------------------- the fused chain of shared two-phase sets

def _fused_case(name):
    """A tiled operator on the CPU with shared column factors, a point
    near its iterates and a seeded direction: SSY "full" and "deferred",
    GCY's natural layout at a "full" view and at a "deferred" one (I =
    512)."""
    if name == "gcy_natural_deferred":
        _, pd = _gcy_disc((32, 16, 8, 2, 8, 2))
        T = P.make_tiled_T_log_gcy(P.GCY(), pd, device="cpu")
        base = np.asarray(P.gcy_loglinear_parts(P.GCY(), pd)["ell0"])
    else:
        T, _, base = _tiled(name)
    x = torch.as_tensor(_near(base, 21, 0.02), dtype=torch.float32)
    v = torch.as_tensor(np.random.default_rng(22).standard_normal(
        base.shape), dtype=torch.float32)
    return T, x, v


FUSED = {"streamed_full": "full", "deferred": "deferred",
         "gcy_natural": "full", "gcy_natural_deferred": "deferred"}


def _fused_step(T, x):
    from sdfs_via_autodiff_tpu_torch.kernels.tangent_two_phase import (
        TwoPhaseTangent)
    from sdfs_via_autodiff_tpu_torch.ops.tangent import Tape
    tape = Tape()
    with torch.no_grad():
        T.twin.primal(x, tape)
    steps = tape.finish()
    return steps, [s for s in steps if isinstance(s, TwoPhaseTangent)]


@pytest.mark.parametrize("name", list(FUSED))
def test_fused_chain_is_the_stepwise_replay(name, monkeypatch):
    """A float32 set with shared column factors records one fused step
    (the GCY natural layout around it: its two crossings), whose CPU
    matvec is the stepwise tape's einsum replay to 1e-6."""
    from sdfs_via_autodiff_tpu_torch.operators import two_phase
    T, x, v = _fused_case(name)
    steps, fused = _fused_step(T, x)
    assert len(fused) == 1 and fused[0].split == FUSED[name]
    assert len(steps) == (3 if name.startswith("gcy") else 1)
    got = tangent_matvec(T.twin, x)(v)
    # The stepwise tape: what the twin records where it does not fuse.
    monkeypatch.setattr(two_phase, "is_dtensor", lambda t: True)
    assert not _fused_step(T, x)[1]
    want = tangent_matvec(T.twin, x)(v)
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("model", ["ssy", "gcy"])
def test_fused_plain_version_takes_float64(model):
    """The fused step's plain version over a float64 twin's tape: the
    replay of the same steps to 1e-12."""
    from sdfs_via_autodiff_tpu_torch.kernels.tangent_two_phase import (
        TwoPhaseTangent, tangent_split)
    from sdfs_via_autodiff_tpu_torch.ops.tangent import Tape, replay
    if model == "ssy":
        _, pd = _ssy_disc((4, 4, 4, 6))
        ops = P.two_phase_operands_ssy(P.SSY(), pd)
    else:
        _, pd = _gcy_disc((32, 16, 8, 2, 8, 2))
        ops = P.two_phase_operands_gcy(P.GCY(), pd)
    T = P.make_eager_two_phase_T(ops, torch.float64, device="cpu")
    base = (np.full(ops.shapes, np.log(800.0)) if model == "ssy" else
            np.asarray(P.gcy_loglinear_parts(P.GCY(), pd)["ell0"]).transpose(
                ops.perm).reshape(ops.shapes))
    x = torch.as_tensor(_near(base, 23, 0.02))
    v = torch.as_tensor(np.random.default_rng(24).standard_normal(
        ops.shapes))
    tape = Tape()
    T.primal(x, tape)
    steps = tape.finish()
    step = TwoPhaseTangent(ops.shapes, tangent_split(ops), None, steps)
    got = step.plain(v)
    assert got.dtype == torch.float64
    assert _rel(got, replay(steps, v)) <= JVP_RTOL64
    assert _rel(step.minus_identity(v), replay(steps, v) - v) <= JVP_RTOL64


def _route_case(name):
    """(twin, point) of the routing test's operators."""
    if name in ("streamed_full", "gcy_natural", "batched", "pair",
                "normalized_conjugated", "strip", "strip_normalized"):
        T, _, base = _tiled(name)
        return T.twin, torch.as_tensor(_near(base, 25, 0.02),
                                       dtype=torch.float32)
    if name == "gcy_no_split":
        # The GCY view (2, 2, 512, 225): I = 512 leaves the c1 pass no
        # layout and J = 225 the c1 product none.
        _, pd = _gcy_disc((32, 16, 15, 2, 15, 2))
        T = P.make_tiled_T_log_gcy(P.GCY(), pd, device="cpu")
        base = np.asarray(P.gcy_loglinear_parts(P.GCY(), pd)["ell0"])
        return T.twin, torch.as_tensor(_near(base, 25, 0.02),
                                       dtype=torch.float32)
    if name == "float64":
        _, pd = _ssy_disc((4, 4, 4, 6))
        T = P.make_eager_two_phase_T(P.two_phase_operands_ssy(P.SSY(), pd),
                                     torch.float64, device="cpu")
        return T, torch.full((4, 4, 4, 6), float(np.log(800.0)),
                             dtype=torch.float64)
    T = _kept_on_jvp("node_chain")
    return T, torch.full((4, 4, 4, 5), float(np.log(800.0)))


# Shared float32 sets (the conjugated-shared one and the strip tier's
# plain set among them) fuse; batched (the strip tier's normalized set,
# continuous SSY), pair, float64 and node-chain twins, and a shared set
# whose shapes have no tangent passes, keep their steps.
ROUTES = {"streamed_full": True, "gcy_natural": True,
          "normalized_conjugated": True, "strip": True,
          "strip_normalized": False, "batched": False, "pair": False,
          "float64": False, "node_chain": False, "gcy_no_split": False}


@pytest.mark.parametrize("name", list(ROUTES))
def test_fused_route_counts_once_a_matvec(name):
    from sdfs_via_autodiff_tpu_torch.kernels.tangent_two_phase import (
        TwoPhaseTangent)
    twin, x = _route_case(name)
    lin = tangent_matvec(twin, x)
    assert isinstance(lin, Linearization)
    v = torch.ones_like(x)
    with recorded() as recs:
        lin(v)
        lin(v)
    counts = [r.count for r in recs if r.name == "sdfs.tangent.fused"]
    matvecs = sum(1 for r in recs if r.name == "sdfs.tangent.matvec")
    assert matvecs == 2
    assert counts == ([1, 1] if ROUTES[name] else [])
    fused = [s for s in lin._steps if isinstance(s, TwoPhaseTangent)]
    assert len(fused) == int(ROUTES[name])
    if not ROUTES[name]:
        assert len(lin._steps) > 1          # the stages, one by one


def test_fused_split_follows_the_primal_configuration():
    """"full" where the primal's pass B runs the c1 pass, "deferred" where
    it runs c1 on the tensor cores: the two Newton cells, the deferred
    SSY tier, a set outside the streamed configurations; none where
    neither has a layout."""
    from sdfs_via_autodiff_tpu_torch.kernels.tangent_two_phase import (
        tangent_split)
    _, pd = _ssy_disc((4, 4, 4, 6))
    ops = P.two_phase_operands_ssy(P.SSY(), pd)
    want = {(32, 32, 32, 384): "full", (12, 16, 512, 256): "deferred",
            (2, 2, 64, 512): "deferred", (103, 41, 64, 512): "full",
            (4, 6, 10, 30): "full", (2, 2, 512, 225): None}
    assert {s: tangent_split(dataclasses.replace(ops, shapes=s))
            for s in want} == want
