"""``polish`` in the port's drivers vs the JAX package's, on the CPU.

A float32 fast stage followed by the float64 Newton polish reaches
JAX's float64 Newton solution within 1e-6 on w (JAX's
``test_discrete_polish_refines_f32_solve``) and the asked tolerance on
the float64 residual, for both drivers; with ``kernel="tiled"`` the
float64 stage linearizes the fast stage's float32 operator
(``tangent_T``).  ``True`` and ``"device"`` keep the caller's device,
``"host"`` lands on the CPU.  Where JAX swallows a failure to build
that operator (``drivers.py:228-229``, a known defect), the port
raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels import tiled_two_phase as jax_tiled

SHAPES = (4, 4, 4, 6)
TAUCHEN = (8, 8, 4, 16)     # small Tauchen set the tiled Newton solves fast
SIZES = (4, 4, 4, 5)
W_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _residual64(model, sol, **kw):
    """max |T64(log w*) - log w*| through the float64 discrete operator."""
    disc = P.discretize_ssy(model, tuple(sol.w_star.shape), **kw)
    T = P.T_ssy_factory(model, disc, space="log", device="cpu")
    ell = torch.log(sol.w_star.double())
    return float(torch.amax(torch.abs(T(ell) - ell)))


def test_discrete_polish_refines_f32_solve():
    sol = P.wc_ratio_discrete(P.SSY(), SHAPES, tol=1e-9,
                              dtype=torch.float32, polish=True, device="cpu")
    assert sol.converged and sol.result.residual <= 1e-9
    assert sol.w_star.dtype == torch.float64
    ref = J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-10)
    np.testing.assert_allclose(sol.w_star.numpy(), np.asarray(ref.w_star),
                               rtol=0, atol=W_ATOL)
    jax_pol = J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-9,
                                  dtype=jnp.float32, polish=True)
    np.testing.assert_allclose(sol.w_star.numpy(), np.asarray(jax_pol.w_star),
                               rtol=0, atol=W_ATOL)


def test_discrete_tiled_polish_reaches_tol():
    # The fast stage runs the tiled operator's plain versions here; the
    # float64 stage takes that operator as its tangent.
    tol = 1e-9
    sol = P.wc_ratio_discrete(P.SSY(), TAUCHEN, kernel="tiled",
                              discretization="tauchen", tol=tol,
                              polish=True, device="cpu")
    assert sol.converged and sol.result.residual <= tol
    assert _residual64(P.SSY(), sol, method="tauchen") <= tol


@pytest.mark.parametrize("kwargs", [
    {},
    {"kernel": "tiled"},
    {"method": "monte_carlo", "mc_draw_size": 30, "dtype": torch.float32},
], ids=["default", "tiled", "monte_carlo_f32"])
def test_continuous_polish_reaches_tol(kwargs):
    tol = 1e-9
    sol = P.wc_ratio_continuous(P.SSY(), SIZES, tol=tol, polish=True,
                                device="cpu", **kwargs)
    assert sol.converged and sol.result.residual <= tol
    assert sol.w_star.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in sol.grids)
    if not kwargs.get("method"):
        ref = J.wc_ratio_continuous(J.SSY(), SIZES, tol=1e-10)
        np.testing.assert_allclose(sol.w_star.numpy(),
                                   np.asarray(ref.w_star), rtol=0,
                                   atol=W_ATOL)


@pytest.mark.parametrize("polish", [True, "device", "host"])
def test_polish_stage_placement(polish, monkeypatch):
    calls = []
    newton = P.solvers.SOLVERS["newton"]

    def spy(T, x0, **kw):
        calls.append((x0.device, x0.dtype, kw.get("tangent_T")))
        return newton(T, x0, **kw)

    monkeypatch.setitem(P.solvers.SOLVERS, "newton", spy)
    sol = P.wc_ratio_continuous(P.SSY(), SIZES, kernel="tiled", tol=1e-9,
                                polish=polish, device="cpu")
    assert sol.converged
    (_, fast_dtype, fast_tan), (pdev, pdtype, tangent) = calls
    assert fast_dtype == torch.float32 and fast_tan is None
    assert pdtype == torch.float64 and sol.w_star.dtype == torch.float64
    # On the caller's device the tiled fast operator is the tangent; the
    # host stage cannot use it (it lives on the caller's device).
    assert pdev == torch.device("cpu") == sol.w_star.device
    if polish == "host":
        assert tangent is None
    else:
        assert tangent is not None and hasattr(tangent, "twin")


def test_invalid_polish_raises_as_jax():
    with pytest.raises(ValueError, match="polish"):
        J.wc_ratio_discrete(J.SSY(), SHAPES, tol=1e-9, polish="gpu")
    with pytest.raises(ValueError, match="polish"):
        P.wc_ratio_discrete(P.SSY(), SHAPES, tol=1e-9, polish="gpu",
                            device="cpu")
    with pytest.raises(ValueError, match="polish"):
        P.wc_ratio_continuous(P.SSY(), SIZES, polish="gpu", device="cpu")


def test_tangent_build_failure_raises_where_jax_passes(monkeypatch):
    # JAX builds the tiled operator a second time for the polish stage's
    # tangent and swallows a failure there (``except Exception: pass``),
    # falling back to the float64 tangent.  The port reuses the fast
    # stage's operator, and a failure to build it raises: no fallback
    # may hide the kernels.
    def failing(*args, **kwargs):
        raise RuntimeError("tiled operator build failed")

    monkeypatch.setattr(P.drivers, "make_tiled_T_log_ssy", failing)
    with pytest.raises(RuntimeError, match="build failed"):
        P.wc_ratio_discrete(P.SSY(), TAUCHEN, kernel="tiled",
                            discretization="tauchen", tol=1e-9,
                            polish=True, device="cpu")

    # JAX: the fast stage gets a float32 operator (a stand-in for the
    # Pallas kernels, which need interpret mode on the CPU), the tangent
    # build fails, and the polish passes silently.
    builds = []

    def second_fails(model, disc, **kwargs):
        builds.append(kwargs)
        if len(builds) > 1:
            raise RuntimeError("tiled operator build failed")
        return J.T_ssy_factory(model, disc, space="log", dtype=jnp.float32)

    monkeypatch.setattr(jax_tiled, "make_tiled_T_log_ssy", second_fails)
    sol = J.wc_ratio_discrete(J.SSY(), SHAPES, kernel="tiled", tol=1e-9,
                              polish="device")
    assert len(builds) == 2 and sol.converged


def test_checkpoint_path_names_its_roadmap_item(tmp_path):
    # checkpoint_path is ported: with polish the float64 stage writes the
    # file, with the JAX drivers' meta of that stage (no kernel key).
    for call in (P.wc_ratio_discrete, P.wc_ratio_continuous):
        path = str(tmp_path / f"{call.__name__}.npz")
        sol = call(P.SSY(), SHAPES, polish=True, checkpoint_path=path,
                   dtype=torch.float32, tol=1e-9, device="cpu")
        ckpt = P.load_solution(path)
        assert ckpt.w_star.dtype == np.float64
        np.testing.assert_array_equal(ckpt.w_star, sol.w_star.numpy())
        assert ckpt.meta["algorithm"] == "newton"
        assert ckpt.meta["tol"] == 1e-9 and "kernel" not in ckpt.meta
        assert ckpt.meta["residual"] == sol.result.residual <= 1e-9
