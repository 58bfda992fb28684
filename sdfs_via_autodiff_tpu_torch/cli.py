"""Command-line interface of the PyTorch port (``sdfs-torch``).

The same subcommands, flags, JSON keys and exit codes as the JAX
package's ``sdfs-tpu`` (``sdfs_via_autodiff_tpu/cli.py``), plus one
global ``--device`` (default ``cuda``: every command runs on the card
unless asked for the CPU, and raises without one):

    sdfs-torch solve ssy --kind discrete --shapes 10,10,10,10 --algorithm newton
    sdfs-torch solve ssy --kind continuous --shapes 4,4,4,6 --checkpoint out.npz
    sdfs-torch simulate ssy --checkpoint out.npz --steps 1000000
    sdfs-torch price --checkpoint out.npz --state 0.01,0,0,0
    sdfs-torch check ssy --shapes 10,10,10,10 --decompose
    sdfs-torch grad ssy --shapes 10,10,10,12 --fields beta,gamma
    sdfs-torch --device cpu info

Checkpoints are the JAX package's format: either package's ``simulate``
and ``price`` read the other's files.  Exit codes: 0 success, 2 a solve
that did not converge, 3 an existence check that fails; a bad argument
exits through ``SystemExit``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _model(name: str):
    from .models.gcy import GCY
    from .models.ssy import SSY
    if name == "ssy":
        return SSY()
    if name == "gcy":
        return GCY()
    raise SystemExit(f"unknown model {name!r} (want ssy|gcy)")


def _parse_shapes(s: str):
    return tuple(int(x) for x in s.split(","))


def _shapes_for(args):
    shapes = _parse_shapes(args.shapes)
    want = 4 if args.model == "ssy" else 6
    if len(shapes) != want:
        raise SystemExit(
            f"--shapes for {args.model} needs {want} comma-separated sizes "
            f"(got {len(shapes)}: {args.shapes})")
    return shapes


def _model_from_ckpt(ckpt):
    """Reconstruct the EXACT calibration the checkpoint was solved at —
    its stored model_params, not the family defaults (a non-default
    checkpoint priced under default dynamics is silently wrong)."""
    from .models.gcy import GCY
    from .models.ssy import SSY
    fam = {"ssy": SSY, "gcy": GCY}[ckpt.model_name.lower()]
    return fam(**ckpt.model_params)


def _reject_degroot_ckpt(ckpt, what):
    if ckpt.meta.get("spec") == "degroot":
        raise SystemExit(
            f"checkpoint stores the de Groot fixed point as ln g* "
            f"(meta.field={ckpt.meta.get('field')!r}); {what} interprets "
            "the stored field as the W/C ratio w* and would produce "
            "garbage — no de Groot pricing pipeline exists yet")


def cmd_solve(args):
    from .drivers import wc_ratio_continuous, wc_ratio_discrete

    model = _model(args.model)
    shapes = _shapes_for(args)
    t0 = time.time()
    if args.spec == "degroot":
        from .drivers import degroot_fixed_point
        dropped = [flag for flag, off in (
            ("--kernel", args.kernel == "xla"),
            ("--baseline", args.baseline is None),
            ("--polish", args.polish is None),
            ("--method", args.method == "quadrature"),
            ("--interp", args.interp == "pre"),
            ("--engine", args.engine == "auto")) if not off]
        if dropped:
            raise SystemExit(
                f"--spec degroot does not support {', '.join(dropped)} "
                "(plain float64 log-tier solve only)")
        sol = degroot_fixed_point(
            model, shapes, kind=args.kind, h=args.h,
            algorithm=args.algorithm, tol=args.tol, space=args.space,
            quad_degree=args.quad_degree, num_std_devs=args.num_std_devs,
            discretization=args.discretization,
            checkpoint_path=args.checkpoint, device=args.device)
        wall = time.time() - t0
        lg = sol.log_g_star
        out = dict(model=args.model, kind=args.kind, spec="degroot",
                   shapes=list(shapes), algorithm=args.algorithm,
                   h_sup=1.0 if args.h is None else args.h,
                   iterations=int(sol.result.iterations),
                   residual=float(sol.result.residual),
                   converged=bool(sol.converged),
                   log_g_min=float(lg.min()), log_g_max=float(lg.max()),
                   log_g_mean=float(lg.mean()), seconds=round(wall, 3))
        print(json.dumps(out))
        return 0 if sol.converged else 2
    if args.kind == "discrete":
        sol = wc_ratio_discrete(
            model, shapes, algorithm=args.algorithm, tol=args.tol,
            space=args.space, kernel=args.kernel, baseline=args.baseline,
            discretization=args.discretization,
            polish=args.polish or False,
            checkpoint_path=args.checkpoint, device=args.device)
    else:
        sol = wc_ratio_continuous(
            model, shapes, algorithm=args.algorithm, tol=args.tol,
            space=args.space, method=args.method, interp=args.interp,
            quad_degree=args.quad_degree, num_std_devs=args.num_std_devs,
            kernel=args.kernel, baseline=args.baseline,
            engine=args.engine, polish=args.polish or False,
            checkpoint_path=args.checkpoint, device=args.device)
    wall = time.time() - t0
    w = sol.w_star
    out = dict(model=args.model, kind=args.kind, shapes=list(shapes),
               algorithm=args.algorithm,
               iterations=int(sol.result.iterations),
               residual=float(sol.result.residual),
               converged=bool(sol.converged),
               w_min=float(w.min()), w_max=float(w.max()),
               w_mean=float(w.double().mean()), seconds=round(wall, 3))
    print(json.dumps(out))
    return 0 if sol.converged else 2


def cmd_simulate(args):
    from .sdf.simulate import simulated_w_moments
    from .sdf.wstar import construct_wstar_callable
    from .utils.checkpoint import load_solution

    ckpt = load_solution(args.checkpoint)
    _reject_degroot_ckpt(ckpt, "simulate")
    model = _model_from_ckpt(ckpt)
    f = construct_wstar_callable(datafile=args.checkpoint,
                                 device=args.device)
    mean, std = simulated_w_moments(model, f, num_steps=args.steps,
                                    seed=args.seed, device=args.device)
    print(json.dumps(dict(model=ckpt.model_name, steps=args.steps,
                          w_mean=round(mean, 4), w_std=round(std, 4))))
    return 0


def cmd_price(args):
    import torch

    from .sdf.pricing import expected_sdf, risk_free_rate
    from .sdf.wstar import construct_wstar_callable
    from .utils.checkpoint import load_solution

    ckpt = load_solution(args.checkpoint)
    _reject_degroot_ckpt(ckpt, "price")
    name = ckpt.model_name.lower()
    model = _model_from_ckpt(ckpt)
    f = construct_wstar_callable(datafile=args.checkpoint,
                                 device=args.device)
    dim = 4 if name == "ssy" else 6
    if args.state is None:
        state = [0.0] * dim          # the mean state
    else:
        state = [float(v) for v in args.state.split(",")]
        if len(state) != dim:
            raise SystemExit(f"--state for {name} needs {dim} "
                             f"comma-separated values (got {len(state)})")
    degree = args.quad_degree or (5 if name == "ssy" else 3)
    x = torch.tensor(state, dtype=torch.float64)
    e_m = float(expected_sdf(model, f, degree, device=args.device)(x))
    rf = float(risk_free_rate(model, f, degree, device=args.device)(x))
    print(json.dumps(dict(model=ckpt.model_name, state=state,
                          quad_degree=degree,
                          expected_sdf=round(e_m, 8),
                          risk_free_rate=round(rf, 8))))
    return 0


def cmd_check(args):
    from .operators.discrete_gcy import discretize_gcy
    from .operators.discrete_ssy import discretize_ssy
    from .ops.grids import build_grid_gcy, build_grid_ssy
    from .utils.spectral import existence_check

    model = _model(args.model)
    shapes = _shapes_for(args)
    disc = grids = None
    if args.kind == "discrete":
        disc = (discretize_ssy if args.model == "ssy" else discretize_gcy)(
            model, shapes)
    else:
        grids = (build_grid_ssy if args.model == "ssy" else build_grid_gcy)(
            model, *shapes, num_std_devs=args.num_std_devs)
    if args.spec == "degroot":
        if args.decompose:
            raise SystemExit("--decompose applies to the standard "
                             "specification's S (the channel split "
                             "assumes the lambda tilt); S~ already IS "
                             "the decomposed form ln beta + ln sup h "
                             "+ ln r(K~)/theta")
        from .operators.degroot import existence_check_degroot
        rep = existence_check_degroot(model, disc, grids=grids,
                                      quad_degree=args.quad_degree,
                                      h=args.h, device=args.device)
        out = dict(
            model=args.model, kind=args.kind, spec="degroot",
            shapes=list(shapes), h_sup=1.0 if args.h is None else args.h,
            spectral_radius=rep.spectral_radius,
            stability_exponent=rep.S_alt,
            exists_unique=rep.exists_unique,
            power_iterations=rep.iterations)
        print(json.dumps(out))
        return 0 if rep.exists_unique else 3
    if args.decompose and args.kind != "discrete":
        raise SystemExit("--decompose needs --kind discrete "
                         "(chain-exact channel split)")
    if disc is not None:
        rep = existence_check(model, disc, device=args.device)
    else:
        rep = existence_check(model, grids=grids,
                              quad_degree=args.quad_degree,
                              device=args.device)
    out = dict(
        model=args.model, kind=args.kind, shapes=list(shapes),
        spectral_radius=rep.spectral_radius,
        stability_exponent=rep.stability_exponent,
        exists_unique=rep.exists_unique,
        power_iterations=rep.iterations)
    if args.decompose:
        from .utils.spectral import stability_decomposition
        dec = stability_decomposition(model, disc, device=args.device)
        out["decomposition"] = dict(
            S=dec.S, ln_beta=dec.ln_beta, S_lambda=dec.S_lambda,
            S_c=dec.S_c, coefficient=dec.coefficient)
    print(json.dumps(out))
    return 0 if rep.exists_unique else 3


def cmd_grad(args):
    import torch

    from .drivers import wc_ratio_differentiable

    model = _model(args.model)
    shapes = _parse_shapes(args.shapes)
    want = 4 if args.model == "ssy" else 6
    if len(shapes) != want:
        raise SystemExit(f"{args.model} needs {want} shape entries")
    fields = tuple(f.strip() for f in args.fields.split(",") if f.strip())
    t0 = time.time()
    wc_fn, p0 = wc_ratio_differentiable(
        model, shapes, fields=fields, quad_degree=args.quad_degree,
        num_std_devs=args.num_std_devs, algorithm=args.algorithm,
        tol=args.tol, device=args.device)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    val = torch.mean(torch.log(wc_fn(p)))
    grads = torch.autograd.grad(val, [p[k] for k in fields])
    print(json.dumps(dict(
        model=args.model, shapes=list(shapes), moment="mean_log_w",
        value=float(val.detach()),
        grad={k: float(g) for k, g in zip(fields, grads)},
        seconds=round(time.time() - t0, 3))))
    return 0


def _power_limit():
    """The card's name and power limit as ``nvidia-smi`` reports them,
    or None where it cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def cmd_info(args):
    import torch

    from . import __version__
    from .config import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    print(json.dumps(dict(
        version=__version__,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=str(dev),
        device_name=torch.cuda.get_device_name(dev) if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 0,
        power_limit=_power_limit() if cuda else None,
    )))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sdfs-torch",
        description="PyTorch + CUDA wealth-consumption / SDF solver "
                    "(SSY, GCY)")
    p.add_argument("--device", default="cuda",
                   help="torch device every command runs on (default "
                        "cuda; raises without a card); 'cpu' runs the "
                        "kernels' plain versions")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve for the W/C ratio fixed point")
    ps.add_argument("model", choices=["ssy", "gcy"])
    ps.add_argument("--kind", choices=["discrete", "continuous"],
                    default="discrete")
    ps.add_argument("--shapes", required=True,
                    help="comma-separated grid sizes, e.g. 10,10,10,10")
    ps.add_argument("--algorithm", default="newton",
                    choices=["newton", "anderson", "successive_approx", "gd",
                             "fused_anderson", "fused_sa"])
    ps.add_argument("--tol", type=float, default=1e-7)
    ps.add_argument("--space", choices=["w", "log"], default=None)
    ps.add_argument("--method", choices=["quadrature", "monte_carlo"],
                    default="quadrature")
    ps.add_argument("--interp", choices=["pre", "post", "loglin"],
                    default="pre")
    ps.add_argument("--quad-degree", type=int, default=5)
    ps.add_argument("--num-std-devs", type=float, default=3.2)
    ps.add_argument("--kernel", choices=["xla", "tiled"], default="xla",
                    help="'tiled' = the float32 CUDA kernels (their plain "
                         "versions with --device cpu); 'xla' = the eager "
                         "float64 operators")
    ps.add_argument("--baseline", default=None,
                    choices=["loglinear", "coarse"],
                    help="baseline normalization (wide grids / f32)")
    ps.add_argument("--engine", choices=["auto", "node_chain", "gather"],
                    default="auto",
                    help="evaluation strategy for post/loglin interp")
    ps.add_argument("--polish", nargs="?", const="device", default=None,
                    choices=["host", "device"],
                    help="refine the fast solve with float64 Newton: "
                         "'device' (default when the flag is bare; IEEE "
                         "f64 on --device) or 'host' (the CPU)")
    ps.add_argument("--discretization",
                    choices=["rouwenhorst", "tauchen"],
                    default="rouwenhorst",
                    help="tauchen spans a fixed +/-3 sigma at any point "
                         "count (the in-envelope choice for fine f32 "
                         "discrete grids)")
    ps.add_argument("--checkpoint", default=None)
    ps.add_argument("--spec", choices=["standard", "degroot"],
                    default="standard",
                    help="recursive-utility specification; 'degroot' "
                         "solves the state-dependent-discount family "
                         "for g = (V/C)^(1-gamma) (log tier; reports "
                         "ln g)")
    ps.add_argument("--h", type=float, default=None,
                    help="constant discount level h for --spec degroot "
                         "(default 1; must lie in (0, 1/beta))")
    ps.set_defaults(fn=cmd_solve)

    pm = sub.add_parser("simulate",
                        help="simulated moments of w* from a checkpoint")
    pm.add_argument("model", choices=["ssy", "gcy"])
    pm.add_argument("--checkpoint", required=True)
    pm.add_argument("--steps", type=int, default=1_000_000)
    pm.add_argument("--seed", type=int, default=1234)
    pm.set_defaults(fn=cmd_simulate)

    pp = sub.add_parser(
        "price", help="conditional E[M'] and risk-free rate from a "
                      "solved checkpoint")
    pp.add_argument("--checkpoint", required=True)
    pp.add_argument("--state", default=None,
                    help="comma-separated state values (default: the "
                         "zero/mean state)")
    pp.add_argument("--quad-degree", type=int, default=None,
                    help="Gauss-Hermite degree per shock (default 5 for "
                         "SSY's 5 shocks, 3 for GCY's 7)")
    pp.set_defaults(fn=cmd_price)

    pc = sub.add_parser(
        "check", help="existence/uniqueness check: beta*r(H)^(1/theta) < 1")
    pc.add_argument("model", choices=["ssy", "gcy"])
    pc.add_argument("--kind", choices=["discrete", "continuous"],
                    default="discrete")
    pc.add_argument("--shapes", required=True)
    pc.add_argument("--quad-degree", type=int, default=5)
    pc.add_argument("--num-std-devs", type=float, default=3.2)
    pc.add_argument("--decompose", action="store_true",
                    help="split S into ln beta + S_lambda + (1-1/psi) S_c "
                    "(companion-paper decomposition; discrete kind)")
    pc.add_argument("--spec", choices=["standard", "degroot"],
                    default="standard",
                    help="recursive-utility specification: standard "
                         "EZ-with-shocks or the de Groot state-dependent-"
                         "discount alternative (S~ = ln beta + ln sup h "
                         "+ ln r(K~)/theta)")
    pc.add_argument("--h", type=float, default=None,
                    help="constant discount level h for --spec degroot "
                         "(default 1; must lie in (0, 1/beta))")
    pc.set_defaults(fn=cmd_check)

    pg = sub.add_parser(
        "grad", help="calibration gradient of mean(log w*) in the model "
        "parameters (implicit function theorem)")
    pg.add_argument("model", choices=["ssy", "gcy"])
    pg.add_argument("--shapes", required=True)
    pg.add_argument("--fields", default="beta,gamma,psi",
                    help="comma-separated model fields to differentiate")
    pg.add_argument("--quad-degree", type=int, default=5)
    pg.add_argument("--num-std-devs", type=float, default=3.2)
    pg.add_argument("--algorithm", default="newton")
    pg.add_argument("--tol", type=float, default=1e-9)
    pg.set_defaults(fn=cmd_grad)

    pi = sub.add_parser("info", help="version, toolchain and device info")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
