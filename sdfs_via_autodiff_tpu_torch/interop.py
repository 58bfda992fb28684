"""Carry a model's parameters and a two-phase operand set across packages.

The SSY dataclass fields and the ``TwoPhaseOperands`` arrays play the role
of weights here.  Both take plain dictionaries — ``dataclasses.asdict`` of
the JAX package's objects with arrays as numpy float64 — so a test can
hand both packages the same numbers without this package importing JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .models.ssy import SSY
from .operators.two_phase import TwoPhaseOperands

__all__ = ["model_from_fields", "operands_from_numpy"]


def _check_fields(cls, d: dict) -> None:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) "
                         f"{', '.join(unknown)}")


def model_from_fields(d: dict) -> SSY:
    """An :class:`SSY` from its field dictionary."""
    _check_fields(SSY, d)
    return SSY(**{k: float(v) for k, v in d.items()})


def operands_from_numpy(d: dict) -> TwoPhaseOperands:
    """A :class:`TwoPhaseOperands` from its field dictionary (arrays as
    numpy float64, optional fields None or absent)."""
    _check_fields(TwoPhaseOperands, d)
    scalars = {"shapes", "theta", "beta"}
    kw = {k: (None if v is None else np.asarray(v, np.float64))
          for k, v in d.items() if k not in scalars}
    return TwoPhaseOperands(shapes=tuple(int(n) for n in d["shapes"]),
                            theta=float(d["theta"]), beta=float(d["beta"]),
                            **kw)
