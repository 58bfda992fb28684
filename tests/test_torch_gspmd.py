"""The single-device operators on a DTensor iterate: the port against
itself on one device and against the JAX package.

In JAX a single-device operator applied to a mesh-sharded array runs
sharded (GSPMD; ``tests/test_sharding.py``).  The port's operators take a
``torch.distributed.tensor.DTensor`` the same way
(``ops/dtensor.py``).  One spawn of four gloo ranks
(``torch_ranks.gspmd_operators``) applies every case of
``torch_ranks.GSPMD_OPS`` on a 2x2 and a 4x1 mesh, compares the
solvers' tangent route with ``torch.func.jvp`` and the hand-placed SSY
operator with the automatic one (world size 1 and the refusals:
``tests/test_torch_gspmd_world1.py``).

Tolerances: JAX's own, against the port's single-device result: 1e-13
absolute for the float64 log-space operators (fields near 6.7; JAX's
``test_sharded_operator_matches_single_device``), 1e-13 relative in w
space (fields near 800), 5e-6 times the field's size for the float32
deep-window operator (sums in another order), 1e-12 for the hand-placed
operator against the automatic one and 1e-13 for the tangent.  Against
the JAX package's single-device operators, the tolerance of the port's
parity test for each: 1e-12 absolute in log space, 1e-12 relative in w
space and for de Groot, 5e-6 times the size for float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import sdfs_via_autodiff_tpu as J
import torch_ranks as tr
from sdfs_via_autodiff_tpu.kernels import fused_discrete as jfd
from sdfs_via_autodiff_tpu.operators import two_phase as jtp


@pytest.fixture(scope="module")
def ranks():
    return tr.spawn("gspmd_operators", 4)


def _jax_operator(name):
    """The JAX package's single-device operator of GSPMD case ``name``."""
    kind, shapes, kw = tr.GSPMD_OPS[name]
    kw = dict(kw)
    if kw.get("dtype") == "float32":
        kw["dtype"] = jnp.float32
    if kind == "ssy":
        m = J.SSY()
        return J.T_ssy_factory(m, J.discretize_ssy(m, shapes), **kw)
    if kind == "gcy":
        m = J.GCY()
        return J.T_gcy_factory(m, J.discretize_gcy(m, shapes), **kw)
    if kind == "ssy_continuous":
        from sdfs_via_autodiff_tpu.operators.continuous_ssy import (
            T_ssy_continuous_factory)
        m = J.SSY()
        return T_ssy_continuous_factory(m, J.build_grid_ssy(m, *shapes),
                                        interp="pre", **kw)
    if kind == "gcy_continuous":
        from sdfs_via_autodiff_tpu.operators.continuous_gcy import (
            T_gcy_continuous_factory)
        m = J.GCY()
        return T_gcy_continuous_factory(
            m, J.build_grid_gcy(m, *shapes), method="quadrature",
            interp="pre", quad_degree=3, **kw)
    from sdfs_via_autodiff_tpu.operators import degroot as jdg
    if kind == "degroot":
        m = J.SSY()
        return jdg.T_degroot_factory(m, J.discretize_ssy(m, shapes), **kw)
    if kind == "degroot_continuous":
        m = J.SSY()
        return jdg.T_degroot_continuous_factory(
            m, J.build_grid_ssy(m, *shapes), quad_degree=3, **kw)
    m = J.SSY()
    disc = J.discretize_ssy(m, shapes)
    if kind == "eager_two_phase":
        return jtp.make_xla_two_phase_T(jtp.two_phase_operands_ssy(m, disc),
                                        jnp.float64)
    M1, M2T, log_kap = jfd.kron_operands_ssy(m, disc, jnp.float64)
    return jfd.make_xla_T_from_operands(
        M1, M2T, log_kap, m.theta, m.beta, shapes, shapes[0] * shapes[1],
        shapes[2] * shapes[3], jnp.float64)


CASES = [(label, name) for label in tr.GSPMD_MESHES for name in tr.GSPMD_OPS]


@pytest.mark.parametrize("label, name", CASES)
def test_operator_on_a_dtensor_matches_the_single_device_one(ranks, label,
                                                            name):
    kw = tr.GSPMD_OPS[name][2]
    for r in ranks:
        res = r[(label, name)]
        assert res["placements_kept"] and res["sharded"]
        if kw.get("dtype") == "float32":
            assert res["max_abs"] <= 5e-6 * res["level"]
        elif kw.get("space") == "w":
            assert res["max_rel"] <= 1e-13
        else:
            assert res["max_abs"] <= 1e-13


@pytest.mark.parametrize("name", sorted(tr.GSPMD_OPS))
def test_operator_on_a_dtensor_matches_jax(ranks, name):
    kind, _, kw = tr.GSPMD_OPS[name]
    T = _jax_operator(name)
    x = tr.gspmd_field(name, getattr(T, "baseline_log_w", None))
    if kw.get("dtype") == "float32":
        x = x.astype(np.float32)
    want = np.asarray(T(jnp.asarray(x)), np.float64)
    got = ranks[0][("2x2", name)]["out"]
    if kw.get("dtype") == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=5e-6 * np.abs(want).max())
    elif kw.get("space") == "w" or kind.startswith("degroot"):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_tangent_route_matches_jvp(ranks, label):
    for r in ranks:
        for name, (err, _) in r[(label, "tangent")].items():
            assert err <= 1e-13, name


@pytest.mark.parametrize("label", sorted(tr.GSPMD_MESHES))
def test_tangent_route_is_the_operators_own(ranks, label):
    # A hand linearization runs on the DTensor; an operator without one
    # (w space) takes the derivative of a VJP.
    for r in ranks:
        routes = {name: route for name, (_, route)
                  in r[(label, "tangent")].items()}
        assert routes == tr.TANGENT_ROUTES


def test_hand_placed_operator_matches_the_automatic_one(ranks):
    for r in ranks:
        res = r["hand_placed"]
        assert res["max_abs"] <= 1e-12
        assert res["auto_kept"] and res["manual_kept"] and res["sharded"]


def test_reductions_span_only_the_distinct_shards(ranks):
    # A mesh axis that replicates the field (tp here) must not sum its
    # copies twice into a dot product, a norm or the element count.
    for r in ranks:
        res = r["distinct"]
        assert res["placements"] == "(Shard(dim=0), Replicate())"
        assert res["group_size"] == 2
        assert res["dot_rel"] <= 1e-13 and res["norm_rel"] <= 1e-13
        assert res["numel"] == 8 * 6 * 4 * 4


def test_an_op_dtensor_cannot_shard_runs_on_replicated_copies(ranks):
    # torch 2.11 refuses some einsums over two sharded axes; the lifting
    # mode then gathers the op's arguments, as XLA would, and puts the
    # result back on the field's placements, derivatives included.
    for r in ranks:
        res = r["fallback"]
        assert res["kept"] and res["calls"] == 2
        assert res["max_abs"] <= 1e-13
        assert res["vjp_max_abs"] <= 1e-13 and res["jvp_max_abs"] <= 1e-13


def test_a_gather_for_an_op_dtensor_cannot_shard_is_announced(ranks):
    # The gather costs the sharding's memory: it warns, naming the op and
    # the placements it gathered.
    for r in ranks:
        caught = r["fallback"]["warnings"]
        assert len(caught) == 1, caught
        category, msg = caught[0]
        assert category == "RuntimeWarning"
        assert "refusing" in msg and "(Shard(dim=0), Shard(dim=1))" in msg


def test_applications_on_a_dtensor_keep_no_lifted_tensors(ranks):
    # Each application lifts the operator's constants and its own
    # temporaries to Replicate(); nothing holds them afterwards, so fifty
    # more applications leave as many DTensors alive as one did.
    for r in ranks:
        res = r["live_dtensors"]
        assert res["n"] == 50
        assert res["after_more"] <= res["after_one"], res
