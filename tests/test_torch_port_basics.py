"""PyTorch port: copied modules, no JAX at runtime, interop, device policy."""

import dataclasses
import filecmp
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu as J
import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu.operators.two_phase import (
    two_phase_operands_ssy as jax_operands_ssy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "sdfs_via_autodiff_tpu_torch"


@pytest.mark.parametrize("rel", ["models/ssy.py", "models/gcy.py",
                                 "ops/rouwenhorst.py", "ops/tauchen.py",
                                 "ops/quadrature.py"])
def test_numpy_modules_are_identical_copies(rel):
    assert filecmp.cmp(ROOT / "sdfs_via_autodiff_tpu" / rel, PORT / rel,
                       shallow=False)


def test_no_module_imports_jax():
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if any(line.strip().startswith(("import jax", "from jax"))
                        for line in p.read_text().splitlines())]
    assert offenders == []


def test_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sdfs_via_autodiff_tpu'] = None\n"
        "import torch, sdfs_via_autodiff_tpu_torch as p\n"
        "m = p.SSY()\n"
        "d = p.discretize_ssy(m, (3, 3, 3, 4))\n"
        "T = p.T_ssy_factory(m, d, space='log', device='cpu')\n"
        "out = T(torch.full((3, 3, 3, 4), 6.0, dtype=torch.float64))\n"
        "assert bool(torch.isfinite(out).all())\n"
        "g = p.GCY()\n"
        "grids = p.build_grid_gcy(g, 3, 3, 2, 2, 8, 2)\n"
        "base = (6.5, [torch.zeros(len(x)).numpy() for x in grids])\n"
        "T = p.make_tiled_T_log_gcy_continuous(g, grids, baseline=base,\n"
        "                                      device='cpu')\n"
        "assert bool(torch.isfinite(T(T.baseline_log_w)).all())\n"
        "F = p.make_fused_T_log_gcy_continuous(g, grids, baseline=base,\n"
        "                                      device='cpu')\n"
        "assert bool(torch.isfinite(F(F.baseline_log_w)).all())\n"
        "sg = p.build_grid_ssy(m, 3, 3, 3, 4)\n"
        "K = p.make_post_interp_kernel_T_ssy(m, sg, quad_degree=2,\n"
        "                                    device='cpu')\n"
        "f = p.construct_wstar_callable(torch.exp(K(torch.zeros(3, 3, 3, 4))),\n"
        "                               sg, device='cpu')\n"
        "assert all(v > 0 for v in p.one_step_w_moments(\n"
        "    m, f, num_draws=100, device='cpu'))\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_model_from_fields_round_trip():
    jm = J.SSY(beta=0.998, gamma=9.5)
    pm = P.model_from_fields(dataclasses.asdict(jm))
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert pm.theta == jm.theta
    with pytest.raises(ValueError, match="no field"):
        P.model_from_fields({"beta": 0.9, "kappa": 1.0})


def test_operands_from_numpy_round_trip():
    jm = J.SSY()
    jops = jax_operands_ssy(jm, J.discretize_ssy(jm, (3, 4, 5, 6)))
    pops = P.operands_from_numpy(dataclasses.asdict(jops))
    assert pops.shapes == jops.shapes and pops.is_plain
    for f in dataclasses.fields(jops):
        a, b = getattr(jops, f.name), getattr(pops, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = P.SSY()
    d = P.discretize_ssy(m, (3, 3, 3, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.T_ssy_factory(m, d, space="log", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.wc_ratio_discrete(m, (3, 3, 3, 4), device="cuda")


def test_entry_points_default_to_cuda():
    # Called without ``device``, a factory and a ``wc_ratio_*`` call ask
    # for the card (and so raise on a machine without one): nothing falls
    # back.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = P.SSY()
    d = P.discretize_ssy(m, (3, 3, 3, 4))
    grids = P.build_grid_ssy(m, 3, 3, 3, 4)
    calls = [lambda: P.T_ssy_factory(m, d, space="log"),
             lambda: P.make_tiled_T_log_ssy(m, d),
             lambda: P.make_fused_T_log_ssy(m, d),
             lambda: P.make_fused_solver_ssy_continuous(m, grids),
             lambda: P.T_ssy_continuous_factory(m, grids),
             lambda: P.wc_ratio_discrete(m, (3, 3, 3, 4)),
             lambda: P.wc_ratio_continuous(m, (3, 3, 3, 4)),
             lambda: P.wc_ratio_continuous(m, (3, 3, 3, 4),
                                           algorithm="fused_anderson")]
    g = P.GCY()
    g_grids = P.build_grid_gcy(g, 3, 3, 2, 2, 8, 2)
    calls += [lambda: P.T_gcy_continuous_factory(g, g_grids),
              lambda: P.make_tiled_T_log_gcy_continuous(g, g_grids),
              lambda: P.make_fused_T_log_gcy_continuous(g, g_grids),
              lambda: P.make_fused_solver_gcy_continuous(g, g_grids),
              lambda: P.make_fused_anderson_gcy_continuous(g, g_grids),
              lambda: P.wc_ratio_continuous(g, (3, 3, 2, 2, 8, 2)),
              lambda: P.wc_ratio_continuous(g, (3, 3, 2, 2, 8, 2),
                                            kernel="tiled"),
              lambda: P.wc_ratio_continuous(g, (3, 3, 2, 2, 8, 2),
                                            algorithm="fused_sa")]
    # The node-chain, gather and post-interp operators and the SDF
    # pipeline.
    nodes, logw = P.ssy_quadrature_nodes(2)
    g_nodes, g_logw = P.gcy_quadrature_nodes(2)
    w = torch.ones(3, 3, 3, 4, dtype=torch.float64)
    step = P.operators.next_state_ssy
    calls += [lambda: P.make_node_chain_T_ssy(m, grids, nodes, logw),
              lambda: P.make_node_chain_T_gcy(g, g_grids, g_nodes, g_logw),
              lambda: P.make_gather_T(lambda x, s: step(m, x, s),
                                      lambda x: x[1], grids, nodes, None,
                                      "post", "log", None, m.beta, m.theta),
              lambda: P.make_post_interp_kernel_T_ssy(m, grids),
              lambda: P.T_ssy_continuous_factory(m, grids, interp="post",
                                                 space="log"),
              lambda: P.T_gcy_continuous_factory(g, g_grids,
                                                 method="monte_carlo",
                                                 interp="post", space="log"),
              lambda: P.wc_ratio_continuous(m, (3, 3, 3, 4), kernel="tiled",
                                            interp="post"),
              lambda: P.wc_ratio_continuous(m, (3, 3, 3, 4),
                                            method="monte_carlo"),
              lambda: P.construct_wstar_callable(w, grids),
              lambda: P.simulate_states(m, 10),
              lambda: P.one_step_w_moments(m, lambda x: x[0], num_draws=10),
              lambda: P.simulated_w_moments(m, lambda x: x[0], num_steps=10)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
