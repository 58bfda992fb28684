"""Versioned checkpoints of solved models.

PyTorch port of ``sdfs_via_autodiff_tpu/utils/checkpoint.py``, in the
same format, so either package reads the other's files: one compressed
``.npz`` with the entries ``version`` (1), ``model_name``,
``model_params`` (the model's fields as JSON), ``n_grids``, ``grid_0``
.. ``grid_{n-1}``, ``w_star`` and ``meta`` (solver settings as JSON).
Everything needed to rebuild the solution callable and to warm-start a
solve.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device

CHECKPOINT_VERSION = 1

__all__ = ["save_solution", "load_solution", "SolutionCheckpoint"]


@dataclasses.dataclass
class SolutionCheckpoint:
    version: int
    model_name: str
    model_params: dict
    grids: Tuple[np.ndarray, ...]
    w_star: np.ndarray
    meta: dict

    def grids_torch(self, device="cuda") -> tuple:
        """The grids as tensors on ``device`` (the card unless the caller
        asks for the CPU), in their stored dtype."""
        dev = resolve_device(device)
        return tuple(torch.as_tensor(g).to(dev) for g in self.grids)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_solution(path: str,
                  model,
                  grids: Sequence,
                  w_star,
                  meta: Optional[dict] = None) -> None:
    """Write a solution checkpoint.

    ``model`` is an SSY/GCY dataclass (its fields are stored as JSON);
    ``grids`` and ``w_star`` are tensors (any device) or arrays, stored
    in their dtype; ``meta`` can carry solver settings, residuals,
    iteration counts.
    """
    payload = {
        "version": np.int64(CHECKPOINT_VERSION),
        "model_name": np.str_(type(model).__name__),
        "model_params": np.str_(json.dumps(dataclasses.asdict(model))),
        "n_grids": np.int64(len(grids)),
        "w_star": _numpy(w_star),
        "meta": np.str_(json.dumps(meta or {})),
    }
    for i, g in enumerate(grids):
        payload[f"grid_{i}"] = _numpy(g)
    np.savez_compressed(path, **payload)


def load_solution(path: str) -> SolutionCheckpoint:
    """Read a checkpoint written by either package; raises ``ValueError``
    on a newer format version."""
    with np.load(path, allow_pickle=False) as data:
        version = int(data["version"])
        if version > CHECKPOINT_VERSION:
            raise ValueError(
                f"checkpoint version {version} is newer than supported "
                f"{CHECKPOINT_VERSION}")
        n = int(data["n_grids"])
        return SolutionCheckpoint(
            version=version,
            model_name=str(data["model_name"]),
            model_params=json.loads(str(data["model_params"])),
            grids=tuple(data[f"grid_{i}"] for i in range(n)),
            w_star=data["w_star"],
            meta=json.loads(str(data["meta"])),
        )
