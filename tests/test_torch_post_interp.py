"""Post/loglin-interpolation operators of the PyTorch port vs the JAX
package, on the CPU.

Covers the interpolant (``ops/interp.py``), the pointwise gather oracle
(``make_gather_T``), the node chains for SSY and GCY, the factories'
node-chain and gather branches, the post-interp kernel's plain version
(what its wrapper runs for CPU tensors) and the driver's post/loglin
branches.  Inputs are made with numpy from a seed and handed to both
packages; Monte Carlo nodes too (the two packages' generators differ).
Tolerances: 1e-12 for float64 functions computed the same way in both
packages (relative in w space, where values are ~700); 1e-11 for the
node chain against the gather (the JAX tests' bound: the same corner
weights summed in another order); 5e-6 for the float32 kernel's plain
version against the JAX kernel in interpret mode; 1e-10 for float64
fixed points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.kernels.post_interp_kernel import (
    make_post_interp_kernel_T_ssy as jax_post_interp_T)
from sdfs_via_autodiff_tpu.operators import continuous_common as jcc
from sdfs_via_autodiff_tpu.operators import continuous_gcy as jcg
from sdfs_via_autodiff_tpu.operators import continuous_ssy as jcs
from sdfs_via_autodiff_tpu.operators import post_interp as jpi
from sdfs_via_autodiff_tpu.ops import interp as jinterp
from sdfs_via_autodiff_tpu.ops.grids import build_grid_gcy as jax_grid_gcy
from sdfs_via_autodiff_tpu.ops.grids import build_grid_ssy as jax_grid_ssy
from sdfs_via_autodiff_tpu.ops.quadrature import (gauss_hermite_normal,
                                                  tensor_quadrature_normal)
from sdfs_via_autodiff_tpu_torch import ops as pops
from sdfs_via_autodiff_tpu_torch.kernels import post_interp_kernel as pk
from sdfs_via_autodiff_tpu_torch.operators import continuous_common as pcc
from sdfs_via_autodiff_tpu_torch.operators import continuous_gcy as pcg
from sdfs_via_autodiff_tpu_torch.operators import continuous_ssy as pcs
from sdfs_via_autodiff_tpu_torch.operators import post_interp as ppi

SIZES = (4, 5, 6, 7)
GSIZES = (3, 4, 3, 3, 4, 3)
KSIZES = (4, 5, 4, 5)          # the post-interp kernel check, degree 4
INTERPS = ["post", "loglin"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Node chains and solver loops run many small ops: one intra-op
    thread keeps them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(sizes, gcy=False):
    """JAX's float64 grids and the same numbers as port tensors."""
    g = (jax_grid_gcy(J.GCY(), *sizes) if gcy
         else jax_grid_ssy(J.SSY(), *sizes))
    return g, P.grids_from_numpy([np.asarray(x) for x in g])


def _ell(sizes, seed, center=700.0, spread=0.1):
    rng = np.random.default_rng(seed)
    return np.log(center) + spread * rng.standard_normal(sizes)


def _jax_gather(model, grids, shocks, weights, interp, space, gcy=False):
    m = jcg if gcy else jcs
    kappa = ((lambda x: m._log_kappa_gcy(model, x[1], x[4])) if gcy
             else (lambda x: m._log_kappa_ssy(model, x[1], x[3])))
    step = m.next_state_gcy if gcy else m.next_state_ssy
    return jcc.make_gather_T(lambda x, s: step(model, x, s), kappa, grids,
                             jnp.asarray(shocks),
                             None if weights is None else jnp.asarray(weights),
                             interp, space, None, model.beta, model.theta)


def _port_gather(model, grids, shocks, weights, interp, space, gcy=False,
                 batch_size=None):
    m = pcg if gcy else pcs
    kappa = ((lambda x: m._log_kappa_gcy(model, x[1], x[4])) if gcy
             else (lambda x: m._log_kappa_ssy(model, x[1], x[3])))
    step = m.next_state_gcy if gcy else m.next_state_ssy
    return pcc.make_gather_T(
        lambda x, s: step(model, x, s), kappa, grids, torch.as_tensor(shocks),
        None if weights is None else torch.as_tensor(weights), interp, space,
        batch_size, model.beta, model.theta, device="cpu")


# ------------------------------------------------------------ interp

def test_lin_interp_matches_jax():
    jg, pg = _grids(SIZES)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(SIZES)
    # Points inside, on and beyond the grid edges (clamped).
    lo = np.array([float(g[0]) for g in jg])
    hi = np.array([float(g[-1]) for g in jg])
    x = (lo[:, None] + (hi - lo)[:, None]
         * rng.uniform(-0.2, 1.2, size=(4, 300)))
    x[:, :4] = np.stack([np.asarray(g)[[0, 1, -2, -1]] for g in jg])
    want = np.asarray(jinterp.lin_interp(jnp.asarray(x), jnp.asarray(vals),
                                         jg))
    got = pops.lin_interp(torch.as_tensor(x), torch.as_tensor(vals), pg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # Exact at grid points.
    np.testing.assert_allclose(got[:4].numpy(),
                               [vals[0, 0, 0, 0], vals[1, 1, 1, 1],
                                vals[-2, -2, -2, -2], vals[-1, -1, -1, -1]],
                               rtol=1e-13, atol=0)
    # A collapsed (size-1) axis interpolates as the remaining ones.
    g1 = [np.asarray(jg[0]), np.asarray([0.5])]
    v1 = rng.standard_normal((SIZES[0], 1))
    x1 = np.stack([x[0, :20], x[1, :20]])
    want1 = np.asarray(jinterp.lin_interp(jnp.asarray(x1), jnp.asarray(v1),
                                          [jnp.asarray(a) for a in g1]))
    got1 = pops.lin_interp(torch.as_tensor(x1), torch.as_tensor(v1),
                           P.grids_from_numpy(g1))
    np.testing.assert_allclose(got1.numpy(), want1, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="leading axis"):
        pops.multilinear_interp(torch.as_tensor(vals), torch.zeros(3, 5))


# ------------------------------------------------------------ gather

@pytest.mark.parametrize("space", ["w", "log"])
@pytest.mark.parametrize("interp", ["post", "pre", "loglin"])
def test_gather_matches_jax(interp, space):
    jg, pg = _grids(SIZES)
    nodes, weights = tensor_quadrature_normal([3] * 4)
    ell = _ell(SIZES, 1)
    x = ell if space == "log" else np.exp(ell)
    want = np.asarray(_jax_gather(J.SSY(), jg, nodes, weights, interp,
                                  space)(jnp.asarray(x)))
    T = _port_gather(P.SSY(), pg, nodes, weights, interp, space)
    got = T(torch.as_tensor(x)).numpy()
    rtol, atol = (1e-12, 0) if space == "w" else (0, 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # Batches of states give the same operator.
    Tb = _port_gather(P.SSY(), pg, nodes, weights, interp, space,
                      batch_size=SIZES[-1] * 12)
    np.testing.assert_allclose(Tb(torch.as_tensor(x)).numpy(), got, rtol=0,
                               atol=1e-12 * np.abs(got).max())


def test_gather_gcy_mc_matches_jax():
    jg, pg = _grids(GSIZES, gcy=True)
    draws = np.random.default_rng(2).standard_normal((6, 40))
    ell = _ell(GSIZES, 3, center=300.0)
    for interp in ("post", "pre"):
        want = np.asarray(_jax_gather(J.GCY(), jg, draws, None, interp,
                                      "log", gcy=True)(jnp.asarray(ell)))
        got = _port_gather(P.GCY(), pg, draws, None, interp, "log",
                           gcy=True)(torch.as_tensor(ell)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        _port_gather(P.GCY(), pg, draws, None, "post", "log", gcy=True,
                     batch_size=7)


# ------------------------------------------------------------ node chains

@pytest.mark.parametrize("interp", INTERPS)
def test_node_chain_ssy_matches_jax_and_gather(interp):
    jg, pg = _grids(SIZES)
    nodes, logw = jpi.ssy_quadrature_nodes(3)
    pn, pl = ppi.ssy_quadrature_nodes(3)
    np.testing.assert_array_equal(pn, nodes)
    np.testing.assert_array_equal(pl, logw)
    ell = _ell(SIZES, 4)
    want = np.asarray(jpi.make_node_chain_T_ssy(
        J.SSY(), jg, nodes, logw, interp=interp)(jnp.asarray(ell)))
    T = ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw, interp=interp,
                                  device="cpu")
    got = T(torch.as_tensor(ell)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    gather = _port_gather(P.SSY(), pg, nodes, np.exp(logw), interp, "log")
    np.testing.assert_allclose(got, gather(torch.as_tensor(ell)).numpy(),
                               rtol=0, atol=1e-11)


def test_node_basis_ssy_matches_jax():
    jg, pg = _grids(SIZES)
    draws = np.random.default_rng(5).standard_normal((4, 9))
    want = jpi.node_basis_ssy(J.SSY(), jg, draws)
    got = ppi.node_basis_ssy(P.SSY(), pg, draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-13, err_msg=k)


def test_node_chain_mc_draws_match_gather():
    # Joint Monte Carlo draws (made with numpy, handed to both packages)
    # are nodes too: no tensor-product structure required.
    jg, pg = _grids(SIZES)
    draws, logw = P.node_set_from_numpy(
        np.random.default_rng(6).standard_normal((4, 100)),
        np.full(100, -np.log(100.0)))
    ell = _ell(SIZES, 7)
    T = ppi.make_node_chain_T_ssy(P.SSY(), pg, draws, logw, chunk=16,
                                  device="cpu")
    got = T(torch.as_tensor(ell)).numpy()
    want = np.asarray(jpi.make_node_chain_T_ssy(
        J.SSY(), jg, draws, logw, chunk=16)(jnp.asarray(ell)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    gather = _port_gather(P.SSY(), pg, draws, None, "post", "log")
    np.testing.assert_allclose(got, gather(torch.as_tensor(ell)).numpy(),
                               rtol=0, atol=1e-11)
    with pytest.raises(ValueError, match="pair up"):
        P.node_set_from_numpy(draws, logw[:-1])


@pytest.mark.parametrize("chunk", [48, 256, 7])
def test_node_chain_chunk_padding(chunk):
    # Q = 256 with chunk 48 pads to 288 (7 to 259); padded nodes carry
    # log-weight -inf and add nothing.
    _, pg = _grids(SIZES)
    nodes, logw = ppi.ssy_quadrature_nodes(4)
    ell = torch.as_tensor(_ell(SIZES, 8))
    T = ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw, chunk=chunk,
                                  device="cpu")
    T_full = ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw, chunk=256,
                                       device="cpu")
    np.testing.assert_allclose(T(ell).numpy(), T_full(ell).numpy(), rtol=0,
                               atol=1e-12)
    arrs, lw = ppi._pad_chunk([torch.ones(5, 2)], torch.zeros(5), 4)
    assert tuple(arrs[0].shape) == (8, 2) and torch.isinf(lw[5:]).all()


@pytest.mark.parametrize("interp", INTERPS)
def test_node_chain_jvp_matches_finite_differences(interp):
    _, pg = _grids(SIZES)
    nodes, logw = ppi.ssy_quadrature_nodes(3)
    T = ppi.make_node_chain_T_ssy(P.SSY(), pg, nodes, logw, interp=interp,
                                  chunk=9, device="cpu")
    ell = torch.as_tensor(_ell(SIZES, 9))
    vec = torch.as_tensor(np.random.default_rng(10).standard_normal(SIZES))
    _, dout = torch.func.jvp(T, (ell,), (vec,))
    assert bool(torch.isfinite(dout).all())
    eps = 1e-6
    fd = (T(ell + eps * vec) - T(ell - eps * vec)) / (2 * eps)
    np.testing.assert_allclose(dout.numpy(), fd.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("interp", INTERPS)
def test_node_chain_gcy_matches_jax_and_gather(interp):
    jg, pg = _grids(GSIZES, gcy=True)
    nodes, weights = tensor_quadrature_normal([3] * 6)
    logw = np.log(weights)
    ell = _ell(GSIZES, 11, center=300.0)
    want = np.asarray(jpi.make_node_chain_T_gcy(
        J.GCY(), jg, nodes, logw, interp=interp, chunk=81)(jnp.asarray(ell)))
    T = ppi.make_node_chain_T_gcy(P.GCY(), pg, nodes, logw, interp=interp,
                                  chunk=81, device="cpu")
    got = T(torch.as_tensor(ell)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    gather = _port_gather(P.GCY(), pg, nodes, weights, interp, "log",
                          gcy=True)
    np.testing.assert_allclose(got, gather(torch.as_tensor(ell)).numpy(),
                               rtol=0, atol=1e-11)


def test_node_chain_gcy_mc_and_jvp():
    jg, pg = _grids(GSIZES, gcy=True)
    draws, logw = P.node_set_from_numpy(
        np.random.default_rng(12).standard_normal((6, 60)),
        np.full(60, -np.log(60.0)))
    basis_j = jpi.node_basis_gcy(J.GCY(), jg, draws)
    basis_p = ppi.node_basis_gcy(P.GCY(), pg, draws)
    for k in basis_j:
        np.testing.assert_allclose(basis_p[k].numpy(), basis_j[k], rtol=0,
                                   atol=1e-13, err_msg=k)
    ell = _ell(GSIZES, 13, center=300.0)
    T = ppi.make_node_chain_T_gcy(P.GCY(), pg, draws, logw, device="cpu")
    got = T(torch.as_tensor(ell)).numpy()
    want = np.asarray(jpi.make_node_chain_T_gcy(
        J.GCY(), jg, draws, logw)(jnp.asarray(ell)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    v = torch.as_tensor(np.random.default_rng(14).standard_normal(GSIZES))
    _, d = torch.func.jvp(T, (torch.as_tensor(ell),), (v,))
    jd = jax.jvp(jpi.make_node_chain_T_gcy(J.GCY(), jg, draws, logw),
                 (jnp.asarray(ell),), (jnp.asarray(v.numpy()),))[1]
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)


# ------------------------------------------------------------ factories

@pytest.mark.parametrize("gcy", [False, True])
def test_factories_dispatch_node_chain_and_gather(gcy):
    sizes = GSIZES if gcy else SIZES
    _, pg = _grids(sizes, gcy=gcy)
    model, factory = ((P.GCY(), P.T_gcy_continuous_factory) if gcy
                      else (P.SSY(), P.T_ssy_continuous_factory))
    ell = torch.as_tensor(_ell(sizes, 15, center=300.0 if gcy else 700.0))
    for interp in INTERPS:
        kw = dict(interp=interp, space="log", quad_degree=2, device="cpu")
        chain = factory(model, pg, **kw)
        gather = factory(model, pg, engine="gather", **kw)
        np.testing.assert_allclose(chain(ell).numpy(), gather(ell).numpy(),
                                   rtol=0, atol=1e-11)
    kw = dict(method="monte_carlo", interp="post", space="log",
              mc_draw_size=24, seed=7, device="cpu")
    chain = factory(model, pg, **kw)
    np.testing.assert_allclose(chain(ell).numpy(),
                               factory(model, pg, engine="gather",
                                       **kw)(ell).numpy(), rtol=0, atol=1e-11)
    # The draws are the seeded generator's, on every device.
    np.testing.assert_array_equal(chain(ell).numpy(),
                                  factory(model, pg, **kw)(ell).numpy())
    other = factory(model, pg, **{**kw, "seed": 8})
    assert not torch.equal(other(ell), chain(ell))


def test_mc_draws_come_from_the_seeded_generator():
    a = pcc.mc_draws(4, 50, 1234)
    assert a.dtype == torch.float64 and tuple(a.shape) == (4, 50)
    gen = torch.Generator().manual_seed(1234)
    assert torch.equal(a, torch.randn((4, 50), generator=gen,
                                      dtype=torch.float64))
    assert not torch.equal(a, pcc.mc_draws(4, 50, 1235))


# ------------------------------------------------------------ kernel B8

def _jax_post_interp_operands(sizes, degree):
    """The JAX kernel's operand stacks, built with the JAX package's node
    bases as its ``make_post_interp_kernel_T_ssy`` builds them."""
    jm = J.SSY()
    jg = jax_grid_ssy(jm, *sizes)
    n_l, n_k, n_i, n_j = sizes
    R, C, d = n_l * n_k, n_i * n_j, degree
    eta1, w1 = gauss_hermite_normal(d)
    b = jpi.node_basis_ssy(jm, jg, np.broadcast_to(eta1, (4, d)).copy())
    logw2 = np.add.outer(np.log(w1), np.log(w1)).reshape(d * d)
    log_A2, log_A3 = jpi._log_kappa_parts_ssy(jm, jg)
    return dict(
        Wr=np.einsum("alL,bkK->ablkLK", b["B_lam"], b["B_c"]).reshape(
            d * d, R, R),
        Wc=np.einsum("aiI,bijJ->abijIJ", b["B_hz"], b["B_z"]).reshape(
            d * d, C, C),
        pay=np.broadcast_to(b["pay"][:, None, :, None],
                            (d, d, n_l, n_k)).reshape(d * d, R),
        off_base=np.add.outer(logw2, logw2),
        lk_row=np.broadcast_to(log_A2[None, :], (n_l, n_k)).reshape(R),
        lk_col=np.broadcast_to(log_A3[None, :], (n_i, n_j)).reshape(C))


def test_post_interp_operands_match_jax():
    _, pg = _grids(KSIZES)
    got = pk.post_interp_operands_ssy(P.SSY(), pg, 4)
    want = P.post_interp_operands_from_numpy(
        _jax_post_interp_operands(KSIZES, 4))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "smax":
            assert abs(got[k] - v) <= 1e-12
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-12, err_msg=k)
    with pytest.raises(ValueError, match="missing"):
        P.post_interp_operands_from_numpy({"Wr": got["Wr"]})


@pytest.mark.parametrize("interp", INTERPS)
def test_post_interp_plain_matches_jax_kernel_interpret(interp):
    # The JAX Pallas kernel in interpret mode (as the JAX package's own
    # tests run it on the CPU) vs the port's kernel wrapper on CPU
    # tensors, i.e. its plain version; both float32.
    jg, pg = _grids(KSIZES)
    ell = _ell(KSIZES, 16).astype(np.float32)
    Tj = jax_post_interp_T(J.SSY(), jg, quad_degree=4, interp=interp,
                           interpret=True)
    want = np.asarray(Tj(jnp.asarray(ell)))
    before = dict(P.POST_INTERP_LAUNCHES)
    T = P.make_post_interp_kernel_T_ssy(P.SSY(), pg, quad_degree=4,
                                        interp=interp, device="cpu")
    got = T(torch.as_tensor(ell))
    assert got.dtype == torch.float32 and tuple(got.shape) == KSIZES
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-6)
    assert P.POST_INTERP_LAUNCHES == before     # CPU: the plain version
    # One application vs the float64 node chain: the JAX tests' 2e-5.
    T64 = ppi.make_node_chain_T_ssy(P.SSY(), pg, *ppi.ssy_quadrature_nodes(4),
                                    interp=interp, device="cpu")
    np.testing.assert_allclose(got.double().numpy(),
                               T64(torch.as_tensor(ell).double()).numpy(),
                               rtol=0, atol=2e-5)


def test_post_interp_T_tangent_and_gradient_ride_the_twin():
    _, pg = _grids(KSIZES)
    T = P.make_post_interp_kernel_T_ssy(P.SSY(), pg, quad_degree=4,
                                        device="cpu")
    T64 = ppi.make_node_chain_T_ssy(P.SSY(), pg, *ppi.ssy_quadrature_nodes(4),
                                    device="cpu")
    ell = torch.as_tensor(_ell(KSIZES, 17), dtype=torch.float32)
    v = torch.as_tensor(np.random.default_rng(18).standard_normal(KSIZES),
                        dtype=torch.float32)
    out, dk = torch.func.jvp(T, (ell,), (v,))
    torch.testing.assert_close(out, T(ell), rtol=0, atol=0)
    torch.testing.assert_close(dk, torch.func.jvp(T.twin, (ell,), (v,))[1],
                               rtol=0, atol=0)
    _, d64 = torch.func.jvp(T64, (ell.double(),), (v.double(),))
    np.testing.assert_allclose(dk.double().numpy(), d64.numpy(), rtol=0,
                               atol=2e-5)
    x = ell.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(T(x).sum(), x)
    x64 = ell.double().requires_grad_(True)
    (g64,) = torch.autograd.grad(T64(x64).sum(), x64)
    np.testing.assert_allclose(g.double().numpy(), g64.numpy(), rtol=0,
                               atol=2e-5)


def test_post_interp_wrapper_refuses_other_devices_and_interps():
    _, pg = _grids(KSIZES)
    ops = pk.post_interp_operands_ssy(P.SSY(), pg, 2)
    f32 = {k: v.float() for k, v in ops.items() if k != "smax"}
    field = torch.ones(20, 20)
    off = f32["off_base"]
    args = (f32["Wr"], f32["Wc"], f32["pay"], off, torch.zeros(1),
            f32["lk_row"], f32["lk_col"], -20.0, 0.998)
    with pytest.raises(ValueError, match="unknown interp"):
        pk.post_interp(field, *args, "pre")
    with pytest.raises(ValueError, match="no post-interp kernel"):
        pk.post_interp(field.to("meta"), *args, "post")


# ------------------------------------------------------------ driver

@pytest.mark.parametrize("interp", INTERPS)
def test_driver_node_chain_matches_jax_fixed_point(interp):
    sizes = (4, 4, 4, 5)
    want = J.wc_ratio_continuous(J.SSY(), sizes, interp=interp,
                                 quad_degree=3, tol=1e-12)
    got = P.wc_ratio_continuous(P.SSY(), sizes, interp=interp,
                                quad_degree=3, tol=1e-12, device="cpu")
    assert got.converged and bool(want.converged)
    assert got.w_star.dtype == torch.float64
    np.testing.assert_allclose(torch.log(got.w_star).numpy(),
                               np.log(np.asarray(want.w_star)), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("interp", INTERPS)
def test_driver_tiled_post_interp_kernel_path(interp):
    # kernel="tiled" runs the post-interp kernel (its plain version on the
    # CPU) by Newton, the JAX default; the float32 fixed point sits within
    # the float32 floor's amplification of the float64 one.
    sizes = (3, 3, 3, 4)
    from sdfs_via_autodiff_tpu_torch import drivers as pdrivers
    assert pdrivers._default_algorithm(P.SSY(), "tiled") == "newton"
    sol = P.wc_ratio_continuous(P.SSY(), sizes, interp=interp, quad_degree=2,
                                kernel="tiled", tol=2e-5, device="cpu")
    assert sol.converged and sol.w_star.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in sol.grids)
    grids64 = P.build_grid_ssy(P.SSY(), *sizes)
    T64 = P.T_ssy_continuous_factory(P.SSY(), grids64, interp=interp,
                                     space="log", quad_degree=2,
                                     device="cpu")
    ell = torch.log(sol.w_star.double())
    assert float((T64(ell) - ell).abs().max()) <= 5e-5


@pytest.mark.parametrize("gcy", [False, True])
def test_driver_monte_carlo_and_gather(gcy):
    # The driver forwards method, mc_draw_size, seed, engine and
    # batch_size to the factory: two SA steps from w = 1 through the
    # driver equal T(T(0)) of the operator the factory builds from the
    # same arguments, for the node chain and for the gather.  (Tiny GCY
    # grids make poor solves: Newton from w = 1 stalls near 1e-2 there.)
    sizes = (3, 3, 2, 2, 3, 2) if gcy else (3, 3, 3, 4)
    model = P.GCY() if gcy else P.SSY()
    factory = P.T_gcy_continuous_factory if gcy else P.T_ssy_continuous_factory
    mc = dict(method="monte_carlo", mc_draw_size=20, seed=3, interp="post")
    grids = (P.build_grid_gcy if gcy else P.build_grid_ssy)(model, *sizes)
    T = factory(model, grids, space="log", device="cpu", **mc)
    want = T(T(torch.zeros(sizes, dtype=torch.float64)))
    for engine in ("auto", "gather"):
        sol = P.wc_ratio_continuous(model, sizes, engine=engine,
                                    batch_size=36, algorithm="sa",
                                    max_iter=2, device="cpu", **mc)
        assert sol.result.iterations == 2
        np.testing.assert_allclose(torch.log(sol.w_star).numpy(),
                                   want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(kernel="tiled", interp="post", baseline="loglinear"), ValueError,
     "no baseline fold"),
    (dict(kernel="tiled", interp="post", method="monte_carlo"), ValueError,
     "quadrature operators"),
    (dict(kernel="tiled", interp="loglin", space="w"), ValueError,
     "in log space"),
    (dict(kernel="tiled", interp="lin"), ValueError, "unknown interp"),
    (dict(kernel="tiled", interp="pre"), NotImplementedError, "item"),
])
def test_driver_validates_kernel_paths_before_solving(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        P.wc_ratio_continuous(P.SSY(), (3, 3, 3, 4), device="cpu", **kwargs)
    if kwargs.get("interp") == "post" and "baseline" in kwargs:
        # The coarse baseline is a float64 solve: refused before it runs.
        with pytest.raises(ValueError, match="no baseline fold"):
            P.wc_ratio_continuous(P.SSY(), (3, 3, 3, 4), kernel="tiled",
                                  interp="post", baseline="coarse",
                                  device="cpu")


def test_gcy_tiled_post_refused():
    with pytest.raises(ValueError, match="pair kernel covers"):
        P.wc_ratio_continuous(P.GCY(), (3,) * 6, kernel="tiled",
                              interp="post", device="cpu")
