"""Reverse mode through the float32 deep-window LSE contraction.

The float32 normalized operators (``baseline="loglinear"``, SSY and GCY)
contract with ``ops/contract._LseMatmulDeep``, whose derivative is a
per-window softmax average.  Its ``backward`` is the transpose of its
``jvp``.  The JAX package's ``_lse_matmul_deep`` is a ``custom_jvp``
that JAX transposes for ``jax.vjp``.

Against the JAX package the port's VJP is held to the transpose of
JAX's JVP: ``jax.jacfwd`` of the JAX operator, transposed and applied to
the cotangent, within 5e-6 relative to its largest entry.  It is also
held to the float64 operators' ``jax.vjp`` within 5e-6 relative (float32
against float64; 1.6e-6 for SSY, 4.3e-6 for GCY, measured here).

``jax.vjp`` of the float32 JAX operator itself is not held to: it is
1-4% off its own JVP's transpose on these inputs.  XLA flushes float32
subnormals, and in the transposed chain the window's cotangent over
u_s (about e^-80) times a small matrix entry is subnormal, so terms are
lost; the forward tangent never forms such products.  With a ones
cotangent at the SSY baseline, ``jax.vjp`` sums to 376.42886; the port,
the float64 operators and JAX's JVP transposed sum to 383.5629.  The
test of that probe names the divergence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P

RTOL = 5e-6
# The probe: the Rouwenhorst (4, 4, 4, 6) SSY set at its baseline, a ones
# cotangent.  JAX's float32 jax.vjp sums to JAX_VJP_SUM; the float64
# operators' VJP sums to F64_SUM.
JAX_VJP_SUM = 376.42886
F64_SUM = 383.56283


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operators(kind):
    """(shapes, JAX factory of dtype, port factory of dtype)."""
    if kind == "ssy":
        shapes = (4, 4, 4, 6)
        jm, pm = J.SSY(), P.SSY()
        jd, pd = J.discretize_ssy(jm, shapes), P.discretize_ssy(pm, shapes)
        return (shapes,
                lambda dt: J.T_ssy_factory(jm, jd, space="log",
                                           baseline="loglinear", dtype=dt),
                lambda dt: P.T_ssy_factory(pm, pd, space="log",
                                           baseline="loglinear", dtype=dt,
                                           device="cpu"))
    shapes = (4, 3, 3, 2, 3, 2)
    jm, pm = J.GCY(), P.GCY()
    jd, pd = J.discretize_gcy(jm, shapes), P.discretize_gcy(pm, shapes)
    return (shapes,
            lambda dt: J.T_gcy_factory(jm, jd, space="log",
                                       baseline="loglinear", dtype=dt),
            lambda dt: P.T_gcy_factory(pm, pd, space="log",
                                       baseline="loglinear", dtype=dt,
                                       device="cpu"))


def _cotangent(shapes, which):
    if which == "ones":
        return np.ones(shapes, np.float32)
    return np.random.default_rng(2).standard_normal(shapes).astype(
        np.float32)


def _port_vjp(T, x, ct):
    _, f = torch.func.vjp(T, torch.as_tensor(x))
    return f(torch.as_tensor(ct))[0].numpy()


CASES = [(k, c) for k in ("ssy", "gcy") for c in ("ones", "random")]


@pytest.mark.parametrize("kind, which", CASES)
def test_vjp_is_the_transpose_of_jax_jvp(kind, which):
    shapes, TJ, TP = _operators(kind)
    tj = TJ(jnp.float32)
    x = np.asarray(tj.baseline_log_w, np.float32)
    ct = _cotangent(shapes, which)
    jac = np.asarray(jax.jacfwd(tj)(jnp.asarray(x)), np.float64)
    want = (jac.reshape(x.size, x.size).T @ ct.reshape(-1)).reshape(shapes)
    got = _port_vjp(TP(torch.float32), x, ct)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("kind, which", CASES)
def test_vjp_matches_the_float64_operators(kind, which):
    shapes, TJ, TP = _operators(kind)
    x = np.asarray(TJ(jnp.float32).baseline_log_w, np.float32)
    ct = _cotangent(shapes, which)
    _, f64 = jax.vjp(TJ(jnp.float64), jnp.asarray(x, jnp.float64))
    want = np.asarray(f64(jnp.asarray(ct, jnp.float64))[0])
    got = _port_vjp(TP(torch.float32), x, ct)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_probe_sum_is_the_float64_one_where_jax_flushes_subnormals():
    shapes, TJ, TP = _operators("ssy")
    tj = TJ(jnp.float32)
    x = np.asarray(tj.baseline_log_w, np.float32)
    ones = np.ones(shapes, np.float32)
    got = float(_port_vjp(TP(torch.float32), x, ones).astype(np.float64)
                .sum())
    np.testing.assert_allclose(got, F64_SUM, rtol=RTOL)
    # The divergence: JAX's float32 reverse mode loses the subnormal
    # products of its transposed chain.
    _, fj = jax.vjp(tj, jnp.asarray(x))
    jax_sum = float(np.asarray(fj(jnp.asarray(ones))[0], np.float64).sum())
    np.testing.assert_allclose(jax_sum, JAX_VJP_SUM, rtol=RTOL)
    assert abs(jax_sum - got) > 1e-2 * got


@pytest.mark.parametrize("kind", ["ssy", "gcy"])
def test_backward_is_the_transpose_of_the_jvp(kind):
    # torch.func.vjp of the JVP (a linear map of the tangent) is its
    # transpose computed by autograd: the hand-written backward gives it
    # to float32 rounding.
    shapes, _, TP = _operators(kind)
    T = TP(torch.float32)
    x = T.baseline_log_w.clone()
    ct = torch.as_tensor(_cotangent(shapes, "random"))
    _, f = torch.func.vjp(T, x)
    (got,) = f(ct)
    lin = lambda dv: torch.func.jvp(T, (x,), (dv,))[1]
    _, fl = torch.func.vjp(lin, torch.zeros(shapes))
    (want,) = fl(ct)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("kind", ["ssy", "gcy"])
def test_derivative_of_the_vjp_is_the_jvp(kind):
    # The DTensor iterate's tangent route (parallel/gspmd.py) runs over
    # backward: reverse mode over it gives the JVP to float32 rounding.
    shapes, _, TP = _operators(kind)
    T = TP(torch.float32)
    x = T.baseline_log_w.clone().requires_grad_(True)
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(
        shapes).astype(np.float32))
    y = T(x)
    u = torch.zeros_like(y, requires_grad=True)
    (g,) = torch.autograd.grad(y, x, u, create_graph=True)
    (got,) = torch.autograd.grad(g, u, v)
    want = torch.func.jvp(T, (x.detach(),), (v,))[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
