"""The reference of a configuration's ``model``: the module
``reference/<model in lower case>.py`` and its ``build``, found by name,
so that a configuration of a new model brings its reference as a new
file."""

from __future__ import annotations

import importlib
import math
import re

from .chain import KoopmansChain

__all__ = ["build_chain"]


def build_chain(model: str, params: dict, shape, *, device="cpu",
                precision: str = "float64") -> KoopmansChain:
    """The chain of ``model`` (e.g. "SSY", "GCY") at ``params`` on a grid
    of ``shape``."""
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", model):
        raise ValueError(f"bad model name {model!r}")
    if not all(math.isfinite(float(v)) for v in params.values()):
        raise ValueError("non-finite model parameter")
    mod = importlib.import_module(f"{__package__}.{model.lower()}")
    return mod.build(params, tuple(shape), device=device,
                     precision=precision)
