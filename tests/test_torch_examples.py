"""The port's examples (``sdfs_via_autodiff_tpu_torch/examples/``) run
end to end on the CPU at small sizes: each ``main`` takes its sizes as
keyword arguments and ``device``, prints its report and returns what it
computed, checked here for the facts each demo reports."""

import importlib
import math

import pytest
import torch

SMALL = {
    "calibration_gradient": dict(sizes=(3, 3, 3, 4), num_draws=1000),
    "degroot_demo": dict(shapes=(3, 3, 3, 4), gcy_sizes=(2, 2, 2, 2, 3, 2)),
    "gcy_demo": dict(discrete_shapes=(2, 2, 2, 2, 2, 2),
                     continuous_sizes=(2, 2, 2, 2, 3, 2), num_steps=500),
    "newton_experiments": dict(sizes=(3, 3, 3, 4), interp_sizes=(3, 3, 3, 4),
                               num_steps=500),
    "pricing_demo": dict(sizes=(4, 4, 4, 5)),
    "scale_demo": dict(ssy_shape=(4, 8, 6, 64), gcy_shape=(4, 3, 3, 4, 3, 4),
                       gcc_shape=(3, 3, 2, 2, 40, 3)),
    "ssy_continuous_demo": dict(sizes=(4, 4, 4, 5), mc_sizes=(3, 3, 3, 4),
                                mc_draw_size=100, num_draws=1000,
                                num_steps=500),
    "sweep_demo": dict(sizes=(3, 3, 3, 4), gammas=(8.0, 8.89)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _finite(*xs):
    return all(math.isfinite(float(x)) for x in xs)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(
        f"sdfs_via_autodiff_tpu_torch.examples.{name}")
    out = mod.main(device="cpu", **SMALL[name])
    assert capsys.readouterr().out.strip()
    if name == "calibration_gradient":
        grad, cal = out
        assert set(grad) == {"beta", "gamma", "psi"}
        assert _finite(*grad.values())
        assert abs(cal.beta - 0.999) < 1e-4
    elif name == "degroot_demo":
        err, sol_g = out
        assert err < 1e-8 and sol_g.converged
    elif name == "gcy_demo":
        sol, solc, (mean, std) = out
        assert sol.converged and solc.converged and _finite(mean, std)
    elif name == "newton_experiments":
        diff, moments = out
        assert diff < 1e-4 and set(moments) == {"pre", "post", "loglin"}
    elif name == "pricing_demo":
        assert all(0 < r < 1 for r in out)
    elif name == "scale_demo":
        assert all(s.converged for s in out)
    elif name == "ssy_continuous_demo":
        assert _finite(*out[0], *out[1])
    else:
        w, res = out
        assert bool(res.converged.all()) and w.shape[0] == 2
