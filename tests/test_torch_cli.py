"""The port's command line (``sdfs-torch``) against the JAX package's
(``sdfs-tpu``), in process on the CPU (``--device cpu``) in float64,
mirroring JAX's ``tests/test_cli.py``.

For every subcommand but ``info`` (whose keys are the port's own) the
JSON line has the JAX CLI's keys on the same arguments, and the same
exit code.  Values: float64 solves of the same operator agree with JAX's
to 1e-9 relative (each Newton solve stops on a step below its tol); the
existence checks to 1e-12 (the same power iteration); ``simulate``
draws from the port's own generator, so only its keys and ranges are
compared.
"""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdfs_via_autodiff_tpu_torch as P
from sdfs_via_autodiff_tpu import cli as jcli
from sdfs_via_autodiff_tpu_torch import cli as pcli

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Solver loops run thousands of small ops: one intra-op thread keeps
    them fast when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys, port=True):
    """(exit code, the JSON line) of one in-process CLI call."""
    rc = main((["--device", "cpu"] if port else []) + argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


def _both(argv, capsys):
    """Run ``argv`` through both CLIs: (rc, port JSON, JAX JSON), with
    the keys and exit codes held equal."""
    rc_p, out_p = _run(pcli.main, argv, capsys)
    rc_j, out_j = _run(jcli.main, argv, capsys, port=False)
    assert rc_p == rc_j
    assert list(out_p) == list(out_j)
    return rc_p, out_p, out_j


def _close(a, b, keys, rtol=RTOL):
    for k in keys:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)


def test_info(capsys):
    rc, out = _run(pcli.main, ["info"], capsys)
    assert rc == 0
    assert set(out) == {"version", "torch", "cuda", "device", "device_name",
                        "device_count", "power_limit"}
    assert out["device"] == "cpu" and out["torch"] == torch.__version__
    assert out["power_limit"] is None


def test_solve_continuous_and_simulate(tmp_path, capsys):
    ckpt, jckpt = str(tmp_path / "c.npz"), str(tmp_path / "j.npz")
    args = ["solve", "ssy", "--kind", "continuous", "--shapes", "4,4,4,6",
            "--algorithm", "newton", "--tol", "1e-8"]
    rc, out = _run(pcli.main, args + ["--checkpoint", ckpt], capsys)
    rc_j, out_j = _run(jcli.main, args + ["--checkpoint", jckpt], capsys,
                       port=False)
    assert rc == rc_j == 0 and list(out) == list(out_j)
    assert out["converged"] is True and out["w_min"] > 1
    _close(out, out_j, ("w_min", "w_max", "w_mean"))

    rc, sim = _run(pcli.main, ["simulate", "ssy", "--checkpoint", ckpt,
                               "--steps", "5000"], capsys)
    rc_j, sim_j = _run(jcli.main, ["simulate", "ssy", "--checkpoint", ckpt,
                                   "--steps", "5000"], capsys, port=False)
    assert rc == rc_j == 0 and list(sim) == list(sim_j)
    assert sim["model"] == "SSY" and sim["steps"] == 5000
    assert sim["w_std"] > 0 and out["w_min"] <= sim["w_mean"] <= out["w_max"]

    # Pricing from the same checkpoint: E[M'] in (0, 1) near the mean
    # state and a risk-free rate consistent with it; the JAX CLI on the
    # port's file prices the same numbers.
    for state in ([], ["--state", "0.01,0,0,0"]):
        args = ["price", "--checkpoint", ckpt, "--quad-degree", "3"] + state
        rc, pr, pr_j = _both(args, capsys)
        assert rc == 0 and 0.0 < pr["expected_sdf"] < 1.0
        assert abs(pr["risk_free_rate"] + math.log(pr["expected_sdf"])) < 1e-6
        assert pr["state"] == pr_j["state"]
        _close(pr, pr_j, ("expected_sdf", "risk_free_rate"), rtol=1e-7)
    assert pr["state"] == [0.01, 0, 0, 0]
    # The port prices JAX's file too.
    rc, pr = _run(pcli.main, ["price", "--checkpoint", jckpt,
                              "--quad-degree", "3"], capsys)
    assert rc == 0 and 0.0 < pr["expected_sdf"] < 1.0


def test_solve_discrete_small(capsys):
    rc, out, out_j = _both(["solve", "gcy", "--kind", "discrete",
                            "--shapes", "2,2,2,2,2,2", "--algorithm",
                            "newton", "--tol", "1e-8"], capsys)
    assert rc == 0 and out["converged"] is True
    _close(out, out_j, ("w_min", "w_max", "w_mean"))


def test_bad_model():
    with pytest.raises(SystemExit):
        pcli.main(["--device", "cpu", "solve", "bad", "--shapes", "2,2"])


def test_gcy_continuous_cli_and_simulate(tmp_path, capsys):
    ckpt = str(tmp_path / "gcy.npz")
    rc, out = _run(pcli.main, [
        "solve", "gcy", "--kind", "continuous", "--shapes", "3,3,3,3,4,3",
        "--algorithm", "newton", "--tol", "1e-7", "--quad-degree", "3",
        "--checkpoint", ckpt], capsys)
    assert rc == 0 and out["converged"] is True
    rc, sim = _run(pcli.main, ["simulate", "gcy", "--checkpoint", ckpt,
                               "--steps", "3000"], capsys)
    assert rc == 0
    assert sim["model"] == "GCY" and sim["w_std"] >= 0


@pytest.mark.parametrize("extra", [[], ["--decompose"],
                                   ["--kind", "continuous", "--shapes",
                                    "4,4,4,4", "--quad-degree", "3"]])
def test_check_command(capsys, extra):
    args = ["check", "ssy", "--kind", "discrete", "--shapes", "3,3,3,3"]
    rc, out, out_j = _both(args + extra, capsys)
    assert rc == 0 and out["exists_unique"] is True
    assert out["stability_exponent"] < 1
    assert out["power_iterations"] == out_j["power_iterations"]
    _close(out, out_j, ("spectral_radius", "stability_exponent"), 1e-12)
    if "--decompose" in extra:
        assert list(out["decomposition"]) == list(out_j["decomposition"])
        _close(out["decomposition"], out_j["decomposition"],
               ("S", "S_lambda", "S_c"), 1e-8)


def test_solve_degroot_spec(capsys):
    rc, out, out_j = _both(["solve", "ssy", "--kind", "discrete", "--shapes",
                            "3,3,3,3", "--spec", "degroot", "--tol", "1e-10",
                            "--h", "0.99"], capsys)
    assert rc == 0 and out["spec"] == "degroot" and out["converged"] is True
    assert out["log_g_min"] <= out["log_g_mean"] <= out["log_g_max"]
    _close(out, out_j, ("log_g_min", "log_g_max", "log_g_mean"))


def test_check_degroot_spec(capsys):
    rc, out, out_j = _both(["check", "ssy", "--kind", "discrete", "--shapes",
                            "3,3,3,3", "--spec", "degroot", "--h", "0.97"],
                           capsys)
    assert rc == 0
    assert out["spec"] == "degroot" and out["h_sup"] == 0.97
    assert out["exists_unique"] is True and out["stability_exponent"] < 0
    _close(out, out_j, ("spectral_radius", "stability_exponent"), 1e-12)


def test_cli_solve_tauchen_discrete(capsys):
    rc, out, out_j = _both(["solve", "ssy", "--kind", "discrete", "--shapes",
                            "4,4,4,6", "--discretization", "tauchen",
                            "--algorithm", "newton", "--tol", "1e-9"], capsys)
    assert rc == 0 and out["converged"] and out["iterations"] > 0
    _close(out, out_j, ("w_min", "w_max", "w_mean"))


def test_grad_command(capsys):
    rc, out, out_j = _both(["grad", "ssy", "--shapes", "4,4,4,4", "--fields",
                            "beta,gamma", "--quad-degree", "3", "--tol",
                            "1e-9"], capsys)
    assert rc == 0 and out["moment"] == "mean_log_w"
    assert set(out["grad"]) == {"beta", "gamma"}
    # beta -> 1 blows up w, so the beta gradient of mean log w is large
    # and positive; gamma raises risk aversion and lowers w.
    assert out["grad"]["beta"] > 10 and out["grad"]["gamma"] < 0
    np.testing.assert_allclose(out["value"], out_j["value"], rtol=RTOL)
    # The adjoint solves stop at their own rtol (1e-8).
    _close(out["grad"], out_j["grad"], ("beta", "gamma"), 1e-6)


def test_checkpoint_consumers_use_stored_calibration(tmp_path, capsys):
    # tests/test_cli.py:138: simulate/price rebuild the EXACT calibration
    # a checkpoint was solved at, and refuse de Groot checkpoints (ln g*,
    # not w*).
    from sdfs_via_autodiff_tpu_torch.utils.checkpoint import load_solution

    tweaked = dataclasses.replace(P.SSY(), gamma=9.5, beta=0.9985)
    path = str(tmp_path / "wc.npz")
    P.wc_ratio_discrete(tweaked, (3, 3, 3, 3), tol=1e-8,
                        checkpoint_path=path, device="cpu")
    ckpt = load_solution(path)
    m = pcli._model_from_ckpt(ckpt)
    assert isinstance(m, P.SSY) and m.gamma == 9.5 and m.beta == 0.9985
    pcli._reject_degroot_ckpt(ckpt, "simulate")      # standard: no-op

    dpath = str(tmp_path / "dg.npz")
    P.degroot_fixed_point(P.SSY(), (3, 3, 3, 3), tol=1e-8, h=0.99,
                          checkpoint_path=dpath, device="cpu")
    with pytest.raises(SystemExit, match="ln g"):
        pcli._reject_degroot_ckpt(load_solution(dpath), "price")
    for argv in (["simulate", "ssy", "--checkpoint", dpath],
                 ["price", "--checkpoint", dpath]):
        for main, pre in ((pcli.main, ["--device", "cpu"]), (jcli.main, [])):
            with pytest.raises(SystemExit, match="ln g"):
                main(pre + argv)


@pytest.mark.parametrize("flags,match", [
    (["--kernel", "tiled"], "--kernel"),
    (["--polish"], "--polish"),
    (["--baseline", "loglinear"], "--baseline"),
    (["--interp", "post"], "--interp"),
])
def test_solve_degroot_rejects_unsupported_flags(flags, match):
    for main, pre in ((pcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match=match):
            main(pre + ["solve", "ssy", "--shapes", "3,3,3,3", "--spec",
                        "degroot"] + flags)


def test_check_shapes_count_validated():
    for main, pre in ((pcli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit, match="6 comma-separated"):
            main(pre + ["check", "gcy", "--kind", "continuous", "--shapes",
                        "10,10,10,10"])
        with pytest.raises(SystemExit, match="--decompose"):
            main(pre + ["check", "ssy", "--kind", "continuous", "--shapes",
                        "3,3,3,3", "--decompose"])


def test_exit_codes_of_failed_solves_and_checks(monkeypatch, capsys):
    # 2: a solve that did not converge; 3: an existence check that fails.
    import sdfs_via_autodiff_tpu_torch.drivers as drivers
    import sdfs_via_autodiff_tpu_torch.utils.spectral as spectral

    real = drivers.wc_ratio_discrete

    def no_converge(*args, **kw):
        sol = real(*args, **kw)
        return dataclasses.replace(sol, result=dataclasses.replace(
            sol.result, converged=False))

    monkeypatch.setattr(drivers, "wc_ratio_discrete", no_converge)
    rc, out = _run(pcli.main, ["solve", "ssy", "--shapes", "3,3,3,3"],
                   capsys)
    assert rc == 2 and out["converged"] is False
    model = P.SSY()
    rep = spectral.existence_check(model, P.discretize_ssy(model,
                                                           (3, 3, 3, 3)),
                                   device="cpu")
    monkeypatch.setattr(spectral, "existence_check", lambda *a, **k:
                        dataclasses.replace(rep, exists_unique=False))
    rc, out = _run(pcli.main, ["check", "ssy", "--shapes", "3,3,3,3"], capsys)
    assert rc == 3 and out["exists_unique"] is False


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["solve", "ssy", "--shapes", "3,3,3,3"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["info"])


def test_new_modules_import_with_jax_blocked():
    # The command line, utils, de Groot and the examples import and run
    # with JAX and the JAX package absent.
    code = (
        "import sys, io, contextlib, json\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sdfs_via_autodiff_tpu'] = None\n"
        "import importlib\n"
        "from sdfs_via_autodiff_tpu_torch import cli, utils\n"
        "from sdfs_via_autodiff_tpu_torch.operators import degroot\n"
        "from sdfs_via_autodiff_tpu_torch.utils import (checkpoint,\n"
        "    spectral, profiling, graphs)\n"
        "for n in ('calibration_gradient', 'degroot_demo', 'gcy_demo',\n"
        "          'newton_experiments', 'pricing_demo', 'scale_demo',\n"
        "          'ssy_continuous_demo', 'sweep_demo'):\n"
        "    importlib.import_module('sdfs_via_autodiff_tpu_torch.examples.'"
        " + n)\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = cli.main(['--device', 'cpu', 'check', 'ssy', '--shapes',\n"
        "                   '3,3,3,3'])\n"
        "assert rc == 0 and json.loads(buf.getvalue())['exists_unique']\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
