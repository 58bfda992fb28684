"""Carry a model's parameters and a two-phase operand set across packages.

The model dataclass fields and the ``TwoPhaseOperands`` arrays play the
role of weights here.  Both take plain dictionaries — ``dataclasses.asdict``
of the JAX package's objects with arrays as numpy float64 — so a test can
hand both packages the same numbers without this package importing JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models.gcy import GCY
from .models.ssy import SSY
from .operators.two_phase import TwoPhaseOperands

__all__ = ["model_from_fields", "operands_from_numpy"]

_MODELS = (SSY, GCY)
# Operand fields that are integer tuples (the JAX package sets the last
# three as attributes of its GCY sets, outside ``dataclasses.asdict``).
_TUPLES = ("shapes", "perm", "inv_perm", "state_shapes")


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
    its ``perm``, ``inv_perm`` and ``state_shapes`` attributes)."""
    _check_fields(TwoPhaseOperands, d)
    kw = {}
    for k, v in d.items():
        if v is None:
            kw[k] = None
        elif k in _TUPLES:
            kw[k] = tuple(int(n) for n in v)
        elif k in ("theta", "beta"):
            kw[k] = float(v)
        else:
            kw[k] = np.asarray(v, np.float64)
    return TwoPhaseOperands(**kw)
