"""Device policy of the PyTorch port.

The JAX package's ``config.py`` picks a backend for the caller.  The
port never does: every factory and ``wc_ratio_*`` entry point takes
``device="cuda"`` by default and runs on the card unless the caller asks
for the CPU (``device="cpu"``, as the tests do); a request for CUDA on a
machine without a card raises, and nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "num_devices"]


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA
    and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; the port does not fall back to the CPU")
    return dev


def num_devices() -> int:
    """The number of devices the program runs on: the world size of the
    default process group when one is initialized (one rank per
    device), else the number of CUDA devices."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()
