"""The plain reference against the port's float64 eager operators, on the
CPU at small grids, and its independence from the program."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import sdfs_via_autodiff_tpu_torch as port
from wcbench import check
from wcbench.reference import build_chain, newton, successive_approx
from wcbench.reference.chain import to_tf32

REFERENCE = Path(__file__).resolve().parent.parent / "reference"

MODELS = {
    "SSY": (port.SSY, port.discretize_ssy, port.T_ssy_factory, (4, 5, 6, 9)),
    "GCY": (port.GCY, port.discretize_gcy, port.T_gcy_factory,
            (5, 4, 3, 3, 4, 3)),
}


def _drawn(cls):
    base = cls()
    return cls(gamma=base.gamma * 1.02, psi=base.psi * 0.98)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_operator_matches_the_ports_float64_operator(name):
    cls, discretize, factory, shape = MODELS[name]
    m = _drawn(cls)
    disc = discretize(m, shape, method="tauchen")
    T = factory(m, disc, space="log", dtype=torch.float64, device="cpu")
    R = build_chain(name, dataclasses.asdict(m), shape)
    g = torch.Generator().manual_seed(0)
    ell = 6.5 + 0.1 * torch.randn(shape, generator=g, dtype=torch.float64)
    assert float((T(ell) - R(ell)).abs().max()) < 1e-12


@pytest.mark.parametrize("name", sorted(MODELS))
def test_linearization_is_the_derivative(name):
    cls, _, _, shape = MODELS[name]
    R = build_chain(name, dataclasses.asdict(_drawn(cls)), shape)
    g = torch.Generator().manual_seed(1)
    ell = 6.5 + 0.1 * torch.randn(shape, generator=g, dtype=torch.float64)
    v = torch.randn(shape, generator=g, dtype=torch.float64)
    out, jvp = R.linearize(ell)
    want = torch.func.jvp(R, (ell,), (v,))[1]
    assert torch.equal(out, R(ell))
    assert float((jvp(v) - want).abs().max()) < 1e-12


def test_newton_and_sa_reach_the_fixed_point():
    shape = (8, 8, 16, 64)
    R = build_chain("SSY", dataclasses.asdict(port.SSY()), shape)
    start = torch.full(shape, 6.68, dtype=torch.float64)
    x, _, res = newton(R, start, 1e-10)
    assert res < 1e-12
    y, _, step = successive_approx(R, start, 2e-5)
    assert step <= 2e-5
    # SA stops far from the fixed point: a step of 2e-5 at a contraction
    # near 0.999 leaves an error near 2e-5 / (1 - 0.999).
    assert 1e-3 < float((y - x).abs().max()) < 0.1


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265],
                     dtype=torch.float32)
    r = to_tf32(x)
    assert r[0] == 1.0 and r[2] == 1.0 + 2 ** -10
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float(((r - x) / x).abs().max()) <= 2 ** -11


def test_port_and_control_readings_at_a_small_grid():
    """At a grid a test can hold, the program's w* is within the
    configuration's limit of the reference and the TF32 control is not
    (the limits themselves were set from the cells' own sizes)."""
    import json
    here = Path(__file__).resolve().parent.parent
    config = json.loads((here / "configs/ssy_tauchen_12.6M.json").read_text())
    traffic = json.loads((here / "traffic/newton_draws.json").read_text())
    limit = json.loads((here / "cells/ssy.newton.draws.json").read_text())[
        "limits"]["logw_err"]
    config["shapes"] = [8, 8, 16, 64]
    params = config["params"]
    ref, _ = check.answer(config, traffic, params, device="cpu")
    sol = port.wc_ratio_discrete(
        port.SSY(**params), config["shapes"], algorithm="newton",
        tol=check.tol_of(config, params), kernel="tiled",
        discretization="tauchen", device="cpu")
    assert check.logw_err(torch.log(sol.w_star.double()), ref) < limit
    ctl, _ = check.answer(config, traffic, params, device="cpu",
                          precision="tf32")
    assert check.logw_err(ctl, ref) > limit


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_either_package():
    names = {n.split(".")[0] for p in REFERENCE.glob("*.py")
             for n in _imports(p)}
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sdfs_via_autodiff_tpu",
                        "sdfs_via_autodiff_tpu_torch"}, names
