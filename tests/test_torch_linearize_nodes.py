"""Newton's tangent built once per step for the node chains, the
log-space gather and the float32 deep windows, on the CPU.

Each operator's ``T.linearize(x)`` (``ops/tangent.py``: one primal with
a tape, then matvecs that replay the stored factors) on inputs made
from numpy seeds:

* float64: within 1e-12 relative (sup norm) of ``torch.func.jvp`` of the
  same operator and within 1e-10 of ``jax.linearize`` of the JAX
  package's counterpart (built from the same grids and nodes; Monte
  Carlo nodes are made with numpy and handed to both);
* float32: within 2e-6 of the ``jvp`` matvec relative to sup |v|, and no
  farther from the float64 linearization than the ``jvp`` matvec is (to
  25%); a second matvec is bitwise the first;
* a matvec calls no exp, log or maximum (a torch-function mode counts
  them).

The node chains run several chunks (``chunk`` below Q, the last one
padded) and the gather several batches of states.  The float32 deep
windows run on Tauchen sets with a ramp of the field along one axis, so
that some outputs are served by the second window (its mask is checked
not empty); they are held to ``jax.jvp`` of the JAX float32 operator
within 5e-6 relative, the bound of the deep windows' VJP test (XLA
flushes float32 subnormals, the port does not).  The stored bytes
follow the designs: Q*N plus the field for a "post" node chain, Q*N for
"loglin", 4n + 1 fields for n deep-window stages.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators import continuous_common as jcc
from sdfs_via_autodiff_tpu.operators import continuous_ssy as jcs
from sdfs_via_autodiff_tpu.operators import post_interp as jpi
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy as jax_grid_ssy
from sdfs_via_autodiff_tpu.ops.quadrature import tensor_quadrature_normal
from sdfs_via_autodiff_tpu_torch.operators import continuous_common as pcc
from sdfs_via_autodiff_tpu_torch.operators import continuous_ssy as pcs
from sdfs_via_autodiff_tpu_torch.operators import post_interp as ppi
from sdfs_via_autodiff_tpu_torch.ops import contract
from sdfs_via_autodiff_tpu_torch.ops.tangent import Linearization
from sdfs_via_autodiff_tpu_torch.solvers.sharding import tangent_matvec

JVP_RTOL64 = 1e-12
JAX_RTOL64 = 1e-10
JVP_RTOL32 = 2e-6
JAX_RTOL32 = 5e-6
SSY_SIZES = (4, 4, 4, 5)
GCY_SIZES = (3, 3, 2, 2, 3, 2)


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
    return float((got - want).abs().max() / v.abs().max())


def _jvp_matvec(T, x, v):
    return torch.func.jvp(lambda y: T(y) - y, (x,), (v,))[1]


def _grids(sizes, gcy=False):
    g = (jax_grid_gcy(J.GCY(), *sizes) if gcy
         else jax_grid_ssy(J.SSY(), *sizes))
    return g, P.grids_from_numpy([np.asarray(x) for x in g])


def _mc_nodes(dim, n, seed):
    return P.node_set_from_numpy(
        np.random.default_rng(seed).standard_normal((dim, n)),
        np.full(n, -np.log(float(n))))


def _case(name):
    """(port operator of a dtype, JAX float64 operator, shapes, level):
    the node chains run 3-4 chunks, the gathers 4 batches."""
    if name.startswith("ssy_chain"):
        _, kind, interp = name.split("_")[1:]
        jg, pg = _grids(SSY_SIZES)
        if kind == "quad":
            nodes, logw = ppi.ssy_quadrature_nodes(3)       # 81 nodes
            chunk = 27
        else:
            nodes, logw = _mc_nodes(4, 64, 21)
            chunk = 20                                      # 4 chunks, padded
        return (lambda dt: ppi.make_node_chain_T_ssy(
                    P.SSY(), pg, nodes, logw, interp=interp, dtype=dt,
                    chunk=chunk, device="cpu"),
                jpi.make_node_chain_T_ssy(J.SSY(), jg, nodes, logw,
                                          interp=interp, chunk=chunk),
                SSY_SIZES, 700.0)
    if name.startswith("gcy_chain"):
        interp = name.split("_")[-1]
        jg, pg = _grids(GCY_SIZES, gcy=True)
        nodes, weights = tensor_quadrature_normal([2] * 6)    # 64 nodes
        logw = np.log(np.asarray(weights))
        nodes = np.asarray(nodes)
        return (lambda dt: ppi.make_node_chain_T_gcy(
                    P.GCY(), pg, nodes, logw, interp=interp, dtype=dt,
                    chunk=24, device="cpu"),
                jpi.make_node_chain_T_gcy(J.GCY(), jg, nodes, logw,
                                          interp=interp, chunk=24),
                GCY_SIZES, 300.0)
    assert name.startswith("gather")
    interp = name.split("_")[-1]
    jg, pg = _grids(SSY_SIZES)
    nodes, weights = tensor_quadrature_normal([3] * 4)
    model = P.SSY()
    jT = jcc.make_gather_T(
        lambda x, s: jcs.next_state_ssy(J.SSY(), x, s),
        lambda x: jcs._log_kappa_ssy(J.SSY(), x[1], x[3]), jg,
        jnp.asarray(nodes), jnp.asarray(weights), interp, "log", None,
        J.SSY().beta, J.SSY().theta)

    def make(dt):
        return pcc.make_gather_T(
            lambda x, s: pcs.next_state_ssy(model, x, s),
            lambda x: pcs._log_kappa_ssy(model, x[1], x[3]),
            [g.to(dt) for g in pg], torch.as_tensor(nodes),
            torch.as_tensor(weights), interp, "log", SSY_SIZES[-1] * 16,
            model.beta, model.theta, device="cpu")
    return make, jT, SSY_SIZES, 700.0


CASES = ["ssy_chain_quad_post", "ssy_chain_quad_loglin",
         "ssy_chain_mc_post", "ssy_chain_mc_loglin", "gcy_chain_post",
         "gcy_chain_loglin", "gather_post", "gather_loglin", "gather_pre"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    make, jT, shapes, level = _case(request.param)
    rng = np.random.default_rng(sum(map(ord, request.param)))
    x = np.log(level) + 0.1 * rng.standard_normal(shapes)
    v = rng.standard_normal(shapes)
    return make, jT, x, v


def test_float64_linearization_is_the_jvp(case):
    make, _, x, v = case
    T = make(torch.float64)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    lin = tangent_matvec(T, xt)
    assert isinstance(lin, Linearization)
    got = lin(vt)
    assert _rel(got, _jvp_matvec(T, xt, vt)) <= JVP_RTOL64
    assert torch.equal(lin(vt), got)


def test_float64_linearization_matches_jax_linearize(case):
    make, jT, x, v = case
    got = make(torch.float64).linearize(torch.as_tensor(x))(
        torch.as_tensor(v))
    _, f = jax.linearize(lambda y: jT(y) - y, jnp.asarray(x))
    assert _rel(got, f(jnp.asarray(v))) <= JAX_RTOL64


def test_float32_linearization_is_the_jvp(case):
    make, _, x, v = case
    T = make(torch.float32)
    xt = torch.as_tensor(x, dtype=torch.float32)
    vt = torch.as_tensor(v, dtype=torch.float32)
    lin = T.linearize(xt)
    got = lin(vt)
    assert got.dtype == torch.float32
    want = _jvp_matvec(T, xt, vt)
    assert _rel_v(got, want, vt) <= JVP_RTOL32
    assert torch.equal(lin(vt), got)
    ref = make(torch.float64).linearize(xt.double())(vt.double())
    assert _rel(got, ref) <= 1.25 * _rel(want, ref)


class _Count(TorchFunctionMode):
    """Counts the torch calls that a matvec must not make: the
    transcendentals and the maxima."""

    NAMES = {"exp", "exp_", "log", "log_", "log1p", "expm1", "amax", "max",
             "maximum", "clamp", "logsumexp"}

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.NAMES:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def _no_transcendental(lin, v):
    lin.build()
    count = _Count()
    with count:
        lin(v)
    return count.n


def test_matvec_runs_no_exp_log_or_max(case):
    make, _, x, v = case
    lin = make(torch.float64).linearize(torch.as_tensor(x))
    assert not _no_transcendental(lin, torch.as_tensor(v))


@pytest.mark.parametrize("interp", ["post", "loglin"])
def test_node_chain_stores_one_factor_per_node_and_the_field(interp):
    # Q = 81 nodes in chunks of 27, 20 (padded to 100) or one chunk: the
    # stored factor covers the real nodes only.
    _, pg = _grids(SSY_SIZES)
    nodes, logw = ppi.ssy_quadrature_nodes(3)
    N = int(np.prod(SSY_SIZES))
    x = torch.full(SSY_SIZES, float(np.log(700.0)))
    for chunk in (27, 20, None):
        T = ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw,
                                      interp=interp, chunk=chunk,
                                      dtype=torch.float32, device="cpu")
        lin = T.linearize(x)
        assert lin.nbytes == 0                  # built on the first matvec
        lin(torch.ones(SSY_SIZES))
        want = 81 * N + (N if interp == "post" else 0)
        assert lin.nbytes == 4 * want, chunk


def test_node_chain_chunks_give_the_same_tangent():
    _, pg = _grids(SSY_SIZES)
    nodes, logw = ppi.ssy_quadrature_nodes(3)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.log(700.0) + 0.1 * rng.standard_normal(SSY_SIZES))
    v = torch.as_tensor(rng.standard_normal(SSY_SIZES))
    outs = [ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw, chunk=c,
                                      device="cpu").linearize(x)(v)
            for c in (81, 27, 7)]
    for o in outs[1:]:
        assert _rel(o, outs[0]) <= JVP_RTOL64


# ------------------------------------------------- float32 deep windows

def _deep(kind):
    """(port float32 operator, JAX float32 operator, x, v): a Tauchen set
    and its baseline plus a ramp along one axis, where some outputs of
    the first stage fall to the second window."""
    if kind == "ssy":
        shapes, ax, span = (4, 4, 4, 6), 0, 20.0
        jd = J.discretize_ssy(J.SSY(), shapes, method="tauchen")
        pd = P.discretize_ssy(P.SSY(), shapes, method="tauchen")
        jT = J.T_ssy_factory(J.SSY(), jd, space="log", baseline="loglinear",
                             dtype=jnp.float32)
        T = P.T_ssy_factory(P.SSY(), pd, space="log", baseline="loglinear",
                            dtype=torch.float32, device="cpu")
    else:
        shapes, ax, span = (4, 3, 3, 2, 3, 2), 5, 6.0
        jd = J.discretize_gcy(J.GCY(), shapes, method="tauchen")
        pd = P.discretize_gcy(P.GCY(), shapes, method="tauchen")
        jT = J.T_gcy_factory(J.GCY(), jd, space="log", baseline="loglinear",
                             dtype=jnp.float32)
        T = P.T_gcy_factory(P.GCY(), pd, space="log", baseline="loglinear",
                            dtype=torch.float32, device="cpu")
    ramp = np.linspace(0.0, span, shapes[ax]).reshape(
        [-1 if d == ax else 1 for d in range(len(shapes))])
    x = (T.baseline_log_w.numpy() + ramp).astype(np.float32)
    v = np.random.default_rng(3).standard_normal(shapes).astype(np.float32)
    return T, jT, torch.as_tensor(x), torch.as_tensor(v)


@pytest.fixture(params=["ssy", "gcy"])
def deep(request, monkeypatch):
    """The deep-window case and the number of outputs each window served
    while the linearization was built."""
    served = []
    windows = contract._deep_windows

    def counted(*args):
        for k, (em, u, first) in enumerate(windows(*args)):
            served.append((k, int(first.sum())))
            yield em, u, first
    monkeypatch.setattr(contract, "_deep_windows", counted)
    T, jT, x, v = _deep(request.param)
    lin = T.linearize(x)
    got = lin(v)
    monkeypatch.setattr(contract, "_deep_windows", windows)
    return T, jT, x, v, lin, got, served


def test_deep_windows_linearize_like_their_jvp(deep):
    T, _, x, v, lin, got, served = deep
    assert any(k == 1 and n > 0 for k, n in served)   # the second window
    assert got.dtype == torch.float32
    assert _rel_v(got, _jvp_matvec(T, x, v), v) <= JVP_RTOL32
    assert torch.equal(lin(v), got)


def test_deep_window_matvec_runs_no_exp_log_or_max(deep):
    T, _, x, v, _, _, _ = deep
    assert not _no_transcendental(T.linearize(x), v)


def test_deep_windows_linearize_like_jax_jvp(deep):
    _, jT, x, v, _, got, _ = deep
    want = jax.jvp(lambda y: jT(y) - y, (jnp.asarray(x.numpy()),),
                   (jnp.asarray(v.numpy()),))[1]
    assert _rel(got, want) <= JAX_RTOL32


def test_deep_windows_store_four_fields_a_stage_and_the_epilogue(deep):
    T, _, x, _, lin, _, _ = deep
    stages = 4 if x.dim() == 4 else 6
    assert lin.nbytes == (4 * stages + 1) * x.numel() * 4


# ---------------------------------------------------- the Newton paths

@pytest.mark.parametrize("interp", ["post", "loglin"])
def test_tiled_post_interp_newton_meets_jax_fixed_point(interp):
    """The kernel path on the CPU (the kernel's plain version): a float32
    Newton stage whose tangent is the twin's linearization, then the
    float64 polish stage with the kernel operator as ``tangent_T`` (the
    twin's linearization again), against JAX's float64 fixed point as
    ``test_driver_node_chain_matches_jax_fixed_point`` holds it."""
    sizes = (3, 3, 3, 4)
    T = P.make_post_interp_kernel_T_ssy(P.SSY(), P.build_grid_ssy(
        P.SSY(), *sizes), 2, interp, device="cpu")
    assert isinstance(tangent_matvec(T.twin, torch.zeros(sizes)),
                      Linearization)
    want = J.wc_ratio_continuous(J.SSY(), sizes, interp=interp,
                                 quad_degree=2, tol=1e-12)
    got = P.wc_ratio_continuous(P.SSY(), sizes, interp=interp, quad_degree=2,
                                kernel="tiled", polish=True, tol=1e-12,
                                device="cpu")
    assert got.converged and bool(want.converged)
    assert got.w_star.dtype == torch.float64
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("engine", ["node_chain", "gather"])
def test_monte_carlo_newton_solves_on_the_linearization(engine):
    # The factory's Monte Carlo operators (node chain and gather on the
    # same draws) reach Newton with their own linearization; both solves
    # meet the same fixed point.
    sizes = (3, 3, 3, 4)
    grids = P.build_grid_ssy(P.SSY(), *sizes)
    kw = dict(method="monte_carlo", mc_draw_size=40, seed=5, interp="post",
              space="log", device="cpu")
    T = P.T_ssy_continuous_factory(P.SSY(), grids, engine=engine, **kw)
    x0 = torch.full(sizes, float(np.log(700.0)), dtype=torch.float64)
    assert isinstance(tangent_matvec(T, x0), Linearization)
    res = P.solve(T, x0, method="newton", tol=1e-12)
    ref = P.solve(P.T_ssy_continuous_factory(P.SSY(), grids, **kw), x0,
                  method="newton", tol=1e-12)
    assert res.converged and ref.converged
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-10)
