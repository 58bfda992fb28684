"""The work of the two kernels of the streamed operator's deferred
configuration, counted from the shapes alone, and the least time one
NVIDIA H100 could take for it (``roofline.bound_ms``: its peaks, each
input read once and each output written once).

The six-state GCY field (z, z_pi, h_z, h_c, h_zpi, h_lam) runs on its
4-D Kronecker view (L, K, I, J) = (h_c, h_lam, z z_pi, h_z h_zpi), R = L K
field rows of I x J entries (float32).  Per application:

- B3, the deferred pass B, contracts the I axis: 2 R I I J products,
  FP32-accurate on the tensor cores (split TF32, the route the kernel
  takes); it reads the field and the (I, I) factor and writes the field.
- B2 deferred, pass C with the c2 factor deferred to it, contracts the J
  axis and then the row axes: 2 R I J J + 2 (I J) R (L + K) FP32
  operations outside the tensor cores (the kernel's route); it reads the
  field and the factors and writes the field.

At the 25.2M-state view (12, 16, 512, 256) these are the port's kernel
table's bounds: B3 25.8 GFLOP, 0.156 ms; B2 deferred 14.3 GFLOP, 0.213 ms.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .roofline import bound_ms

__all__ = ["gcy_view", "deferred_b_work", "deferred_c_work",
           "deferred_b_bound_ms", "deferred_c_bound_ms"]


def gcy_view(shapes: Sequence[int]) -> Tuple[int, int, int, int]:
    """(L, K, I, J) of the six-state grid ``shapes``."""
    z, z_pi, h_z, h_c, h_zpi, h_lam = shapes
    return h_c, h_lam, z * z_pi, h_z * h_zpi


def deferred_b_work(view: Sequence[int]) -> dict:
    """``bound_ms`` arguments of one B3 launch at ``view``."""
    L, K, I, J = view
    R = L * K
    return {"products": 2.0 * R * I * I * J,
            "nbytes": 4.0 * (2 * R * I * J + I * I)}


def deferred_c_work(view: Sequence[int]) -> dict:
    """``bound_ms`` arguments of one deferred B2 launch at ``view``."""
    L, K, I, J = view
    R, C = L * K, I * J
    return {"flop": 2.0 * R * I * J * J + 2.0 * C * R * (L + K),
            "nbytes": 4.0 * (2 * R * C + J * J + L * L + K * K + R + C)}


def deferred_b_bound_ms(view: Sequence[int]) -> float:
    return bound_ms(**deferred_b_work(view))


def deferred_c_bound_ms(view: Sequence[int]) -> float:
    return bound_ms(**deferred_c_work(view))
