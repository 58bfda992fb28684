"""Reverse mode through the tiled operators: the port against ``jax.vjp``.

The JAX package's tiled operators are ``jax.custom_jvp`` functions, so
``jax.vjp`` transposes their twin's linear tangent; the port's streamed
and strip operators give ``backward`` (and so ``torch.func.vjp``) the
eager twin's transpose.  One case per configuration: plain (streamed
"full" and the strip tier), deferred, batched (continuous SSY), the GCY
natural layout and the continuous-GCY pair set.  The JAX operators run
their Pallas kernels in interpret mode.  Tolerance 5e-6 relative to the
largest entry of JAX's VJP (float32 chains summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import tiled_two_phase as jtt

RTOL = 5e-6
# The input of the probe that found the fault: the (4,4,4,6) Tauchen set
# at ell = 6.0 with a ones cotangent, whose JAX VJP sums to 383.04987.
PROBE_SUM = 383.04987


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssy(shapes, method):
    jm, pm = J.SSY(), P.SSY()
    return (jm, J.discretize_ssy(jm, shapes, method=method),
            pm, P.discretize_ssy(pm, shapes, method=method))


def _case(name):
    """(port T, JAX T, ell, cotangent) of one case, numpy float32."""
    rng = np.random.default_rng(7)
    if name in ("plain", "strip", "deferred"):
        shapes = (2, 2, 64, 512) if name == "deferred" else (4, 4, 4, 6)
        jm, jd, pm, pd = _ssy(shapes, "tauchen")
        engine = "strip" if name == "strip" else "auto"
        T = P.make_tiled_T_log_ssy(pm, pd, device="cpu", engine=engine)
        TJ = jtt.make_tiled_T_log_ssy(jm, jd, engine=engine, interpret=True)
        ell = np.full(shapes, 6.0, np.float32)
        if name == "deferred":
            ell = ell + 0.05 * rng.standard_normal(shapes).astype(np.float32)
        ct = np.ones(shapes, np.float32)
    elif name == "batched":
        sizes = (4, 5, 4, 8)
        jg = J.build_grid_ssy(J.SSY(), *sizes)
        pg = P.build_grid_ssy(P.SSY(), *sizes)
        T = P.make_tiled_T_log_ssy_continuous(P.SSY(), pg, 3, device="cpu")
        TJ = jtt.make_tiled_T_log_ssy_continuous(J.SSY(), jg, 3,
                                                 interpret=True)
        ell = (np.log(700.0) + 0.02 * rng.standard_normal(sizes)
               ).astype(np.float32)
        ct = rng.standard_normal(sizes).astype(np.float32)
    elif name == "gcy":
        shapes = (4, 3, 3, 2, 3, 2)
        jm, pm = J.GCY(), P.GCY()
        T = P.make_tiled_T_log_gcy(
            pm, P.discretize_gcy(pm, shapes, method="tauchen"), device="cpu")
        TJ = jtt.make_tiled_T_log_gcy(
            jm, J.discretize_gcy(jm, shapes, method="tauchen"),
            interpret=True)
        ell = (np.log(300.0) + 0.1 * rng.standard_normal(shapes)
               ).astype(np.float32)
        ct = rng.standard_normal(shapes).astype(np.float32)
    else:                                                 # "pair"
        sizes = (8, 3, 2, 4, 128, 2)    # the smallest the JAX pair tier takes
        jg = J.build_grid_gcy(J.GCY(), *sizes)
        pg = P.grids_from_numpy([np.asarray(g) for g in jg])
        T = P.make_tiled_T_log_gcy_continuous(P.GCY(), pg, 5,
                                              baseline="loglinear",
                                              device="cpu")
        TJ = jtt.make_tiled_T_log_gcy_continuous(
            J.GCY(), jg, 5, baseline="loglinear", interpret=True)
        ell = (T.baseline_log_w.numpy()
               + 0.02 * rng.standard_normal(tuple(T.baseline_log_w.shape))
               ).astype(np.float32)
        ct = rng.standard_normal(ell.shape).astype(np.float32)
    return T, TJ, ell, ct


CASES = ["plain", "strip", "deferred", "batched", "gcy", "pair"]


@pytest.mark.parametrize("name", CASES)
def test_vjp_matches_jax(name):
    T, TJ, ell, ct = _case(name)
    engine = getattr(T, "engine", None)
    assert engine == {"strip": "strip", "deferred": "streamed-deferred",
                      "pair": "streamed-pair"}.get(name, "streamed")
    out, vjp = torch.func.vjp(T, torch.as_tensor(ell))
    (g,) = vjp(torch.as_tensor(ct))
    out_j, vjp_j = jax.vjp(TJ, jnp.asarray(ell))
    (g_j,) = vjp_j(jnp.asarray(ct))
    g_j = np.asarray(g_j, np.float64)
    scale = float(np.abs(g_j).max())
    err = float(np.abs(g.double().numpy() - g_j).max())
    assert err <= RTOL * scale, (name, err, scale)
    if name in ("plain", "strip"):
        assert abs(float(g.double().sum()) - PROBE_SUM) <= RTOL * PROBE_SUM


@pytest.mark.parametrize("name", ["plain", "strip", "batched", "gcy"])
def test_backward_is_the_twins_transpose(name):
    T, _, ell, ct = _case(name)
    x = torch.as_tensor(ell).requires_grad_(True)
    (T(x) * torch.as_tensor(ct)).sum().backward()
    x2 = torch.as_tensor(ell).requires_grad_(True)
    (T.twin(x2) * torch.as_tensor(ct)).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=0)
