"""Deferred-c2 passes and the GCY tiled operator vs the JAX package.

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them; the port's plain versions (what its
dispatchers run for CPU tensors) take the same numpy inputs.  The
operand set is that of JAX's ``TestDeferredC2GCY``: GCY at (30, 8, 16,
4, 8, 8), view (4, 8, 240, 128), where both packages choose the deferred
configuration.  Tolerances: 5e-6 abs on log-domain outputs; pass B's
midway values sit near theta*log(800) ~ -241, where one float32 ulp is
1.5e-5, so there the bound is 5e-6 plus one float32 rounding of the
value.  The operator is held to the float64 per-axis chain at 5e-6 and
its tangent to JAX's at 2e-4 (the JAX package's own bound for the tiled
tangent).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels.streamed_two_phase import (
    _deferred_b_config, _streamed_config, build_b_call_deferred, build_c_call)
from sdfs_via_autodiff_tpu.kernels.tiled_two_phase import (
    make_tiled_T_log_gcy as jax_make_tiled_T_log_gcy)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    two_phase_operands_gcy as jax_operands_gcy)
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

SHAPES6 = (30, 8, 16, 4, 8, 8)     # (z, z_pi, h_z, h_c, h_zpi, h_lam)
SMALL6 = (4, 3, 3, 2, 3, 2)        # full configuration
ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the whole module, its module-scoped
    fixtures included.  With torch's CPU worker threads, pass B's plain
    version now and then returned one worker's share of the field rows
    (four of 32) up to 10 ulps off, from one process to the next; on one
    thread it agrees with the Pallas interpreter within one ulp every
    time (ROADMAP C).  One thread also keeps the operator tests fast when
    test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ell(shapes, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return np.log(800.0) + scale * rng.standard_normal(shapes)


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _cross(jops):
    return P.operands_from_numpy({**dataclasses.asdict(jops),
                                  "perm": jops.perm,
                                  "inv_perm": jops.inv_perm,
                                  "state_shapes": jops.state_shapes})


@pytest.fixture(scope="module")
def operands():
    jm = J.GCY()
    jd = J.discretize_gcy(jm, SHAPES6)
    jops = jax_operands_gcy(jm, jd)
    return jm, jd, jops, _cross(jops)


@pytest.fixture(scope="module")
def midway(operands):
    """Pass B of both packages on the same view field."""
    _, _, jops, _ = operands
    L, K, I, J_ = jops.shapes
    R = L * K
    ell = _f32(_ell(jops.shapes, seed=5)).reshape(R, I, J_)
    TB, TJ = _deferred_b_config(jops.shapes)
    call, _ = build_b_call_deferred(
        R_rows=R, I=I, J=J_, TB=TB, TJ=TJ, theta=float(jops.theta),
        prec=jax.lax.Precision.HIGHEST, trx="accurate", has_sub=False,
        dtype=jnp.float32, interpret=True)
    want = np.asarray(call(jnp.asarray(ell), jnp.asarray(_f32(jops.W_c1))))
    got = st.pass_b_deferred_plain(_t(ell), _t(np.asarray(jops.W_c1).T),
                                   float(jops.theta))
    return got, want


def test_both_packages_choose_the_deferred_configuration(operands):
    _, _, jops, pops = operands
    assert _streamed_config(jops)["kind"] == "deferred"
    assert P.streamed_config(pops) == "deferred"
    assert P.streamed_supported(pops)


def test_pass_b_deferred_plain_matches_pallas_kernel(midway):
    """Both packages compute out = m + log(s), s = sum over I' of
    W_c1[i, i'] exp(a[i'] - m), a = theta*ell, in float32, each within
    one ulp of the exact value (measured: JAX 1.0004 ulps at worst, the
    port on one thread 1.0), inside 5e-6 plus one float32 rounding
    (EPS32 |out|, two ulps) of the values ~ -240."""
    got, want = midway
    assert got.shape == want.shape
    lim = ATOL + EPS32 * np.abs(want)
    assert np.all(np.abs(got.numpy() - want) <= lim)


def test_pass_c_deferred_plain_matches_pallas_kernel(operands, midway):
    _, _, jops, _ = operands
    L, K, I, J_ = jops.shapes
    R, C = L * K, I * J_
    mid = midway[0].reshape(R, C)            # realistic midway input
    th, be = float(jops.theta), float(jops.beta)
    call, _ = build_c_call(
        shapes=jops.shapes, C_cols=C, theta=th, beta=be,
        prec=jax.lax.Precision.HIGHEST, trx="accurate", mode="lse",
        c2_batched=False, c2_deferred=True, dtype=jnp.float32,
        interpret=True)
    add_col = _f32(jops.add_col).reshape(C)
    want = np.asarray(call(jnp.asarray(mid.numpy()),
                           jnp.asarray(_f32(jops.W_c2)),
                           jnp.asarray(_f32(jops.W_r1)),
                           jnp.asarray(_f32(jops.W_r2)),
                           jnp.asarray(_f32(jops.add_row)),
                           jnp.asarray(add_col.reshape(1, C))))
    got = st.pass_c_deferred_plain(mid, _t(np.asarray(jops.W_c2).T),
                                   _t(jops.W_r1), _t(jops.W_r2),
                                   _t(jops.add_row), _t(add_col), th, be)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# At SMALL6 the JAX package declines its streamed kernels under the TPU
# compiler's layout rules (n_r2 % 8) and runs its strip kernels.
@pytest.mark.parametrize("shapes,engine,jax_engine", [
    (SHAPES6, "streamed-deferred", "streamed-deferred"),
    (SMALL6, "streamed", "strip")])
def test_gcy_operator_matches_f64_and_jax_tangent(shapes, engine,
                                                  jax_engine):
    jm, pm = J.GCY(), P.GCY()
    jd, pd = J.discretize_gcy(jm, shapes), P.discretize_gcy(pm, shapes)
    T = P.make_tiled_T_log_gcy(pm, pd, device="cpu")
    assert (T.engine, T.mode) == (engine, "lse")
    ell = _ell(shapes, seed=6)
    got = T(torch.as_tensor(ell, dtype=torch.float32))
    assert got.shape == shapes and got.dtype == torch.float32
    T64 = J.T_gcy_factory(jm, jd, space="log", jit=False)
    want = np.asarray(T64(jnp.asarray(ell)))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=ATOL)
    # Tangent: the port's jvp rides the eager twin, JAX's the XLA twin.
    jT = jax_make_tiled_T_log_gcy(jm, jd, interpret=True)
    assert jT.engine == jax_engine
    v = 0.01 * _ell(shapes, seed=7)
    ell32, v32 = _f32(ell), _f32(v)
    jt = np.asarray(jax.jvp(jT, (jnp.asarray(ell32),),
                            (jnp.asarray(v32),))[1])
    out, pt = torch.func.jvp(T, (torch.as_tensor(ell32),),
                             (torch.as_tensor(v32),))
    np.testing.assert_allclose(pt.numpy(), jt, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(out.numpy(), got.numpy())


def test_view_layout_and_natural_twin(operands):
    _, _, _, pops = operands
    pm = P.GCY()
    T = P.make_tiled_T_log_gcy(pm, P.discretize_gcy(pm, SHAPES6),
                               device="cpu")
    ell = torch.as_tensor(_ell(SHAPES6, seed=8), dtype=torch.float32)
    view = T.to_view(ell)
    assert tuple(view.shape) == tuple(SHAPES6[p] for p in pops.perm)
    assert torch.equal(T.from_view(view), ell)
    got = T.from_view(T.view_T(view.reshape(pops.shapes))
                      .reshape(view.shape))
    np.testing.assert_array_equal(got.numpy(), T(ell).numpy())
    np.testing.assert_allclose(T.twin(ell).numpy(), T(ell).numpy(), rtol=0,
                               atol=ATOL)


def test_fast_mode_rejected_on_deferred_sets(operands):
    _, _, _, pops = operands
    with pytest.raises(ValueError, match="LSE only"):
        P.make_streamed_T_log(pops, mode="fast", device="cpu")
    T = P.make_streamed_T_log(pops, device="cpu")
    assert (T.mode, T.engine) == ("lse", "streamed-deferred")


def test_cpu_tensors_run_the_plain_deferred_versions(operands):
    _, _, _, pops = operands
    before = dict(st.LAUNCHES)
    T = P.make_streamed_T_log(pops, device="cpu")
    T(torch.as_tensor(_ell(pops.shapes), dtype=torch.float32))
    assert st.LAUNCHES == before


def test_configuration_by_shared_memory():
    rng = np.random.default_rng(0)

    def ops(L, K, I, J_):
        W = lambda n: rng.random((n, n))
        return P.TwoPhaseOperands(
            shapes=(L, K, I, J_), W_r1=W(L), W_r2=W(K), W_c1=W(I),
            W_c2=W(J_), add_row=np.zeros((L, K)), add_col=np.zeros((I, J_)),
            theta=-36.0, beta=0.9987)

    assert P.streamed_config(ops(4, 8, 6, 64)) == "full"
    # A (512, 256) column group needs 0.5 MB of pass-B block: deferred.
    assert P.streamed_config(ops(12, 16, 512, 256)) == "deferred"
    assert st.pass_b_deferred_smem_bytes(512) <= st.SMEM_LIMIT
    # Two (192, 64) blocks with 16-column chunks share an SM.
    assert st.pass_c_deferred_tiles(12, 16) == (64, 16)
    # No (I, 32) strip fits beyond I ~ 1400: not covered.
    # The strip tier runs it.
    wide = ops(2, 2, 2048, 64)
    assert P.streamed_config(wide) is None
    assert P.make_tiled_T_log(wide, device="cpu").engine == "strip"
    # A folded baseline on a deferred set (the conjugated normalized GCY
    # set at 25.2M) runs the deferred configuration, as in JAX.
    normalized = dataclasses.replace(ops(12, 16, 512, 256),
                                     sub_row=np.zeros((12, 16)),
                                     sub_col=np.zeros((512, 256)))
    assert P.streamed_config(normalized) == "deferred"
