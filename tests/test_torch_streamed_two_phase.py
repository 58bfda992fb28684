"""PyTorch port of the streamed two-phase kernels vs the JAX Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as the JAX package's
own tests run them; the port's plain versions (what its dispatchers run
for CPU tensors) take the same numpy inputs.  Operand sets cross via
``interop``.  Tolerances: 5e-6 abs on log-domain outputs near log(800)
and 5e-6 relative on the fast-mode linear midway field (float32, sums in
another order, CPU exp/log vs the JAX package's software f32
transcendentals).  The lse-mode midway field sits near theta*log(800) ~
-107, where one float32 ulp is 7.6e-6: there the bound is 5e-6 plus one
float32 rounding of the value.
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
    build_b_call, build_c_call)
from sdfs_via_autodiff_tpu.kernels.streamed_two_phase import (
    make_streamed_T_log as jax_make_streamed_T_log)
from sdfs_via_autodiff_tpu.operators.two_phase import (
    two_phase_operands_ssy as jax_operands_ssy)
from sdfs_via_autodiff_tpu_torch.kernels import streamed_two_phase as st

SHAPES = (4, 8, 6, 64)
ATOL = 5e-6
EPS32 = float(np.finfo(np.float32).eps)


def _ell(shapes, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return np.log(800.0) + scale * rng.standard_normal(shapes)


@pytest.fixture(scope="module")
def operands():
    jm = J.SSY()
    jops = jax_operands_ssy(jm, J.discretize_ssy(jm, SHAPES))
    return jops, P.operands_from_numpy(dataclasses.asdict(jops))


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a, np.float32))


def _pass_b_both(jops, mode):
    L, K, I, J_ = jops.shapes
    R = L * K
    ell = _f32(_ell(SHAPES)).reshape(R, I, J_)
    call, _ = build_b_call(
        R_rows=R, I=I, J=J_, theta=float(jops.theta),
        prec=jax.lax.Precision.HIGHEST, trx="accurate", mode=mode,
        has_sub=False, c2_here=True, dtype=jnp.float32, interpret=True)
    want = call(jnp.asarray(ell), jnp.asarray(_f32(jops.W_c1)),
                jnp.asarray(_f32(jops.W_c2)))
    got = st.pass_b_plain(_t(ell), _t(jops.W_c1), _t(np.asarray(jops.W_c2).T),
                          float(jops.theta), mode)
    return got, want


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_b_plain_matches_pallas_kernel(operands, mode):
    jops, _ = operands
    got, want = _pass_b_both(jops, mode)
    if mode == "fast":
        (mid, s), (mid_j, s_j) = got, want
        mid_j = np.asarray(mid_j)
        np.testing.assert_allclose(mid.numpy(), mid_j, rtol=5e-6, atol=0)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0,
                                   atol=ATOL)
    else:
        mid_j = np.asarray(want)
        lim = ATOL + EPS32 * np.abs(mid_j)
        assert np.all(np.abs(got.numpy() - mid_j) <= lim)


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_pass_c_plain_matches_pallas_kernel(operands, mode):
    jops, _ = operands
    L, K, I, J_ = jops.shapes
    R, C = L * K, I * J_
    b, _ = _pass_b_both(jops, mode)          # realistic midway input
    th, be = float(jops.theta), float(jops.beta)
    call, _ = build_c_call(
        shapes=jops.shapes, C_cols=C, theta=th, beta=be,
        prec=jax.lax.Precision.HIGHEST, trx="accurate", mode=mode,
        c2_batched=False, dtype=jnp.float32, interpret=True)
    add_col = _f32(jops.add_col).reshape(C)
    common = [_t(jops.W_r1), _t(jops.W_r2), _t(jops.add_row), _t(add_col)]
    if mode == "fast":
        mid, s = b
        mid = mid.reshape(R, C)
        S = torch.amax(s).reshape(1)
        scale = torch.exp(s - S)
        want = call(jnp.asarray(mid.numpy()), jnp.asarray(scale.numpy()),
                    jnp.asarray(_f32(jops.W_r1)), jnp.asarray(_f32(jops.W_r2)),
                    jnp.asarray(_f32(jops.add_row)),
                    jnp.asarray(add_col.reshape(1, C)),
                    jnp.asarray(S.numpy()))
        got = st.pass_c_plain(mid, scale, S, *common, th, be, "fast")
    else:
        mid = b.reshape(R, C)
        want = call(jnp.asarray(mid.numpy()), jnp.asarray(_f32(jops.W_r1)),
                    jnp.asarray(_f32(jops.W_r2)),
                    jnp.asarray(_f32(jops.add_row)),
                    jnp.asarray(add_col.reshape(1, C)))
        got = st.pass_c_plain(mid, None, None, *common, th, be, "lse")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("mode", ["fast", "lse"])
def test_operator_matches_jax_kernels_and_f64(operands, mode):
    jops, pops = operands
    ell = _ell(SHAPES)
    jT = jax_make_streamed_T_log(jops, mode=mode, precision="highest",
                                 interpret=True)
    want = np.asarray(jT(jnp.asarray(ell, jnp.float32)), np.float64)
    pT = P.make_streamed_T_log(pops, mode=mode, device="cpu")
    got = pT(torch.as_tensor(ell, dtype=torch.float32)).double().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    m = P.SSY()
    T64 = P.T_ssy_factory(m, P.discretize_ssy(m, SHAPES), space="log",
                          device="cpu")
    np.testing.assert_allclose(got, T64(torch.as_tensor(ell)).numpy(),
                               rtol=0, atol=ATOL)


def test_auto_mode_is_fast_for_plain(operands):
    _, pops = operands
    T = P.make_streamed_T_log(pops, device="cpu")
    assert T.mode == "fast"


def test_jvp_through_twin(operands):
    _, pops = operands
    T = P.make_streamed_T_log(pops, device="cpu")
    ell = torch.as_tensor(_ell(SHAPES), dtype=torch.float32)
    v = torch.as_tensor(0.01 * _ell(SHAPES, seed=1), dtype=torch.float32)
    out, got = torch.func.jvp(T, (ell,), (v,))
    want = torch.func.jvp(T.twin, (ell,), (v,))[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), T(ell).numpy(), rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_versions(operands):
    _, pops = operands
    before = dict(st.LAUNCHES)
    T = P.make_streamed_T_log(pops, device="cpu")
    T(torch.as_tensor(_ell(SHAPES), dtype=torch.float32))
    assert st.LAUNCHES == before


def test_coverage_and_uncovered_sets(operands):
    _, pops = operands
    assert P.streamed_supported(pops)
    # A (64, 512) column group needs 262 KB of pass-B shared memory: the
    # deferred configuration covers it.
    m = P.SSY()
    big = P.two_phase_operands_ssy(m, P.discretize_ssy(
        m, (2, 2, 64, 512), method="tauchen"))
    assert P.streamed_config(big) == "deferred"
    # (2048, 64) fits neither pass B's (I, J) block nor the deferred
    # pass B's (I, 32) strip.
    wide = P.two_phase_operands_ssy(m, P.discretize_ssy(
        m, (2, 2, 2048, 64), method="tauchen"))
    assert not P.streamed_supported(wide)
    assert P.make_tiled_T_log(wide, device="cpu").engine == "strip"
    # A folded baseline on shared factors runs the full configuration, and
    # so does a mid_col correction (lse mode); a batched c1 factor without
    # a lazy form has no conjugated-shared form: the strip tier runs it.
    normalized = dataclasses.replace(pops, sub_row=pops.add_row,
                                     sub_col=pops.add_col)
    assert P.streamed_config(normalized) == "full"
    with_mid = dataclasses.replace(normalized, mid_col=pops.add_col)
    assert P.streamed_config(with_mid) == "full"
    T = P.make_tiled_T_log(with_mid, device="cpu")
    assert (T.engine, T.mode) == ("streamed", "lse")
    c1_batched = dataclasses.replace(pops, W_c1=np.broadcast_to(
        pops.W_c1, (SHAPES[3],) + pops.W_c1.shape))
    assert not P.streamed_supported(c1_batched)
    assert P.make_tiled_T_log(c1_batched, device="cpu").engine == "strip"


@pytest.mark.parametrize("option", [{"precision": "3x"},
                                    {"transcendentals": "mixed"},
                                    {"interpret": True}])
def test_tpu_only_options_are_rejected(option):
    m = P.SSY()
    d = P.discretize_ssy(m, SHAPES)
    with pytest.raises(ValueError, match="TPU-only"):
        P.make_tiled_T_log_ssy(m, d, device="cpu", **option)
    with pytest.raises(ValueError, match="TPU-only"):
        P.wc_ratio_discrete(m, SHAPES, kernel="tiled", device="cpu",
                            **option)
