"""``trace_len`` and ``SolveResult.error_trace``: the port against JAX.

The JAX package's trace test (``tests/test_solvers.py:91-97``) on its
affine map, and the same request through ``solve`` and Newton: the
trace has the requested length, is padded with NaN, and its entries
equal JAX's to 1e-12 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfs_via_autodiff_tpu.solvers import newton_solver as jax_newton
from sdfs_via_autodiff_tpu.solvers import solve as jax_solve
from sdfs_via_autodiff_tpu.solvers import successive_approx as jax_sa
from sdfs_via_autodiff_tpu_torch.solvers import (newton_solver,
                                                 successive_approx, solve)

A = np.array([[0.5, 0.2], [0.1, 0.6]])
B = np.array([1.0, 2.0])


def _affine_torch(x):
    return torch.as_tensor(A) @ x + torch.as_tensor(B)


def _affine_jax(x):
    return jnp.asarray(A) @ x + jnp.asarray(B)


def _both(trace_len, method, **kw):
    x_t = torch.zeros(2, dtype=torch.float64)
    x_j = jnp.zeros(2)
    if method == "sa":
        got = successive_approx(_affine_torch, x_t, trace_len=trace_len,
                                **kw)
        want = jax_sa(_affine_jax, x_j, trace_len=trace_len, **kw)
    elif method == "newton":
        got = newton_solver(_affine_torch, x_t, trace_len=trace_len, **kw)
        want = jax_newton(_affine_jax, x_j, trace_len=trace_len, **kw)
    else:
        got = solve(_affine_torch, x_t, method="successive_approx",
                    trace_len=trace_len, **kw)
        want = jax_solve(_affine_jax, x_j, method="successive_approx",
                         trace_len=trace_len, **kw)
    return got, want


def test_trace_recording():
    res, _ = _both(16, "sa", tol=1e-10)
    t = res.error_trace.numpy()
    assert t.shape == (16,)
    valid = t[~np.isnan(t)]
    assert len(valid) >= 5
    assert np.all(np.diff(valid[:5]) < 0)


@pytest.mark.parametrize("method, trace_len, kw", [
    ("sa", 16, dict(tol=1e-10)),          # the JAX test: a padded tail
    ("sa", 64, dict(tol=1e-10)),
    ("sa", 5, dict(tol=1e-10)),           # overflow: the last slot moves
    ("sa", 8, dict(tol=1e-14, max_iter=11)),
    ("solve", 16, dict(tol=1e-10)),
    ("newton", 6, dict(tol=1e-10)),
])
def test_trace_matches_jax(method, trace_len, kw):
    got, want = _both(trace_len, method, **kw)
    t, t_j = got.error_trace.numpy(), np.asarray(want.error_trace)
    assert t.shape == t_j.shape == (trace_len,)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(t_j))
    np.testing.assert_allclose(t, t_j, rtol=0, atol=1e-12)
    assert got.iterations == int(want.iterations)


def test_no_trace_by_default():
    res = successive_approx(_affine_torch, torch.zeros(2, dtype=torch.float64),
                            tol=1e-10)
    assert res.error_trace is None
