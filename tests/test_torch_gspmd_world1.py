"""World size 1 and the refusals of the DTensor path.

One spawn of one gloo rank (``torch_ranks.gspmd_world1``): on a 1 x 1
mesh the single-device operators applied to a DTensor, and the SA,
Anderson and Newton solves from a DTensor start, are the single-device
computation bit for bit (every DTensor op runs the local op, and each
reduction over one rank returns its input; Newton's tangent, the
derivative of a VJP there, gives the same steps).  The kernel-backed
operators and solvers refuse a DTensor with a ``ValueError`` naming
``parallel.streamed_shard_map_factory`` and ``T.twin``, before any
launch or gather; a DTensor Newton solve refuses ``inner="dense"`` and
``tangent_T``, and ``method="gd"`` refuses a DTensor start.  At a
DTensor start the float32 deep windows run their own linearization on
the DTensor, while the node chains, whose linearization is
single-device, keep the derivative of a VJP.
"""

import pytest

import torch_ranks as tr

KERNEL_BACKED = ("streamed", "tiled", "strip", "tiled_gcy", "fused",
                 "post_interp", "fused_sa", "fused_anderson",
                 "solve_streamed")


@pytest.fixture(scope="module")
def world1():
    return tr.spawn("gspmd_world1", 1)[0]


@pytest.mark.parametrize("key", KERNEL_BACKED)
def test_kernel_backed_operators_refuse_a_dtensor(world1, key):
    msg = world1["refusals"][key]
    assert "not a DTensor" in msg
    assert "streamed_shard_map_factory" in msg and "T.twin" in msg


@pytest.mark.parametrize("key, match", [
    ("dense", "Krylov inner solvers without tangent_T"),
    ("tangent_T", "Krylov inner solvers without tangent_T"),
    ("gd", "takes a plain tensor")])
def test_solver_options_a_dtensor_does_not_take(world1, key, match):
    assert match in world1["refusals"][key]


def test_a_kernel_operators_twin_takes_the_dtensor(world1):
    assert world1["refusals"]["twin_kept"]


@pytest.mark.parametrize("name", ["ssy_log", "ssy_normalized_f32",
                                  "gcy_log", "ssy_continuous", "degroot"])
def test_world_size_1_operator_is_bitwise_single_device(world1, name):
    assert world1[name]


@pytest.mark.parametrize("method", ["sa", "anderson", "newton"])
def test_world_size_1_solve_is_bitwise_single_device(world1, method):
    res = world1[method]
    assert res["equal"], res
    assert res["iterations"][0] == res["iterations"][1]


@pytest.mark.parametrize("name, route", [
    ("ssy_normalized_f32", "_LocalLinearization"),
    ("node_chain_f32", "VjpLinearization")])
def test_dtensor_tangent_route_of_the_new_linearizations(world1, name,
                                                         route):
    # The float32 deep windows linearize on the DTensor (their operator
    # takes one); the node chain keeps the derivative of a VJP there.
    # Either matvec is the single-device linearization's to float32
    # rounding (2e-6 of sup |v|).
    got_route, rel_v = world1["tangent"][name]
    assert got_route == route
    assert rel_v <= 2e-6


def test_node_chain_newton_from_a_dtensor_start(world1):
    # The derivative of a VJP there, the chain's own linearization on
    # one device: the same float64 fixed point (tol 1e-11).
    route, max_abs, converged = world1["tangent"]["node_chain_newton"]
    assert route == "VjpLinearization" and converged
    assert max_abs <= 1e-10
