"""Carry a model's parameters and operand sets across packages.

The model dataclass fields, the ``TwoPhaseOperands`` arrays, the
two-matmul operands ``(M1, M2T, log_kap[, sub])`` of the fused tier, the
continuous grids, the node sets of the node-chain operators, the
post-interp kernel's operand stacks and a solved ``(w_star, grids)``
play the role of weights here.  All take plain
containers — ``dataclasses.asdict`` of the JAX package's objects, or its
arrays — as numpy float64, so a test can hand both packages the same
numbers without this package importing JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.gcy import GCY
from .models.ssy import SSY
from .operators.two_phase import TwoPhaseOperands

__all__ = ["model_from_fields", "operands_from_numpy",
           "kron_operands_from_numpy", "grids_from_numpy",
           "node_set_from_numpy", "post_interp_operands_from_numpy",
           "solution_from_numpy"]

# The post-interp kernel's operand stacks (kernels/post_interp_kernel.py).
_POST_INTERP_KEYS = ("Wr", "Wc", "pay", "off_base", "lk_row", "lk_col")

_MODELS = (SSY, GCY)
# Operand fields that are integer tuples (the JAX package sets all but
# ``shapes`` as attributes of its GCY sets, outside ``dataclasses.asdict``).
_TUPLES = ("shapes", "perm", "inv_perm", "state_shapes", "pair_shapes")


def _check_fields(cls, d: dict) -> None:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) "
                         f"{', '.join(unknown)}")


def model_from_fields(d: dict):
    """An :class:`SSY` or, when a key names a GCY-only field, a
    :class:`GCY` from its field dictionary (SSY's fields are a subset of
    GCY's)."""
    for cls in _MODELS:
        if set(d) <= {f.name for f in dataclasses.fields(cls)}:
            return cls(**{k: float(v) for k, v in d.items()})
    _check_fields(GCY, d)


def operands_from_numpy(d: dict) -> TwoPhaseOperands:
    """A :class:`TwoPhaseOperands` from its field dictionary (arrays as
    numpy float64, optional fields None or absent; for a JAX GCY set add
    its ``perm``, ``inv_perm`` and ``state_shapes`` attributes, and for a
    continuous-GCY set its ``pair_c2`` and ``pair_shapes``: the set's
    ``W_c2`` is then the JAX package's broadcast placeholder and is
    dropped, the port keeps None)."""
    _check_fields(TwoPhaseOperands, d)
    kw = {}
    for k, v in d.items():
        if v is None:
            kw[k] = None
        elif k in _TUPLES:
            kw[k] = tuple(int(n) for n in v)
        elif k in ("theta", "beta"):
            kw[k] = float(v)
        elif k == "pair_c2":
            kw[k] = tuple(np.asarray(a, np.float64) for a in v)
        else:
            kw[k] = np.asarray(v, np.float64)
    if kw.get("pair_c2") is not None:
        kw["W_c2"] = None
    return TwoPhaseOperands(**kw)


def kron_operands_from_numpy(operands) -> tuple:
    """The fused tier's two-matmul operands ``(M1, M2T, log_kap)``,
    ``(M1, M2T, log_kap, sub)`` or the continuous-GCY seven-tuple
    ``(M1, M2T, log_kap, shapes, rows, cols, sub)`` (e.g. the JAX
    package's ``kron_operands_*`` results) in the same order: arrays as
    float64 CPU tensors, integers and shape tuples as Python ints; a
    ``None`` entry stays None."""
    def convert(a):
        if a is None:
            return None
        if isinstance(a, (int, np.integer)):
            return int(a)
        if isinstance(a, tuple):
            return tuple(int(n) for n in a)
        return torch.as_tensor(np.array(a, np.float64))
    return tuple(convert(a) for a in operands)


def grids_from_numpy(grids) -> tuple:
    """Continuous state grids (1-D arrays, e.g. the JAX package's
    ``build_grid_ssy`` result) as float64 CPU tensors."""
    return tuple(torch.as_tensor(np.array(g, np.float64)) for g in grids)


def node_set_from_numpy(nodes, log_weights) -> tuple:
    """A node chain's joint shock nodes (dim, Q) and log-weights (Q,) as
    numpy float64 (e.g. draws made with numpy from a seed, handed to both
    packages' ``make_node_chain_T_*``)."""
    nodes = np.array(nodes, np.float64)
    log_weights = np.array(log_weights, np.float64)
    if nodes.ndim != 2 or log_weights.shape != (nodes.shape[1],):
        raise ValueError(f"nodes {nodes.shape} and log-weights "
                         f"{log_weights.shape} do not pair up")
    return nodes, log_weights


def post_interp_operands_from_numpy(d: dict) -> dict:
    """The post-interp kernel's operand stacks ``Wr``, ``Wc``, ``pay``,
    ``off_base``, ``lk_row``, ``lk_col`` (arrays, e.g. built with the JAX
    package's node bases) as float64 CPU tensors, plus ``smax`` =
    max(pay) + max(off_base), in the layout of
    :func:`.kernels.post_interp_kernel.post_interp_operands_ssy`."""
    missing = sorted(set(_POST_INTERP_KEYS) - set(d))
    if missing:
        raise ValueError(f"missing operand(s) {', '.join(missing)}")
    out = {k: torch.as_tensor(np.array(d[k], np.float64))
           for k in _POST_INTERP_KEYS}
    out["pay"] = out["pay"].reshape(out["Wr"].shape[0], -1)
    out["lk_row"], out["lk_col"] = (out["lk_row"].reshape(-1),
                                    out["lk_col"].reshape(-1))
    out["smax"] = float(out["pay"].max() + out["off_base"].max())
    return out


def solution_from_numpy(w_star, grids) -> tuple:
    """A solved field and its grids (e.g. the JAX package's
    ``WCSolution.w_star`` and ``.grids``) as float64 CPU tensors, the
    arguments of :func:`.sdf.construct_wstar_callable`."""
    return (torch.as_tensor(np.array(w_star, np.float64)),
            grids_from_numpy(grids))
