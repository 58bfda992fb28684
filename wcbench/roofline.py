"""The least time one NVIDIA H100 (SXM) could take for one application of
the discrete Koopmans operator, whatever implements it.

The work is counted from the grid alone.  One application contracts the
field once along each axis, 2 N n_axis FLOP per axis (N grid points);
it needs one exponential per input entry and one logarithm per output
entry of H, and the epilogue log(1 + beta exp(h / theta)) two more; it
reads the input field once and writes the output once (float32), plus
the per-axis matrices.  The bound is the largest of: the products at the
rate of FP32-accurate tensor-core products (split TF32, three TF32
products per FP32 one: 495 / 3 TFLOP/s), the other FP32 work at 67
TFLOP/s, the bytes at 3.35 TB/s, and the special functions at 16 per
clock per SM (the card's SM count and maximum SM clock).  These are the
peaks and the arithmetic of the port's kernel table, applied to the
whole operator.  Published peaks: NVIDIA's H100 SXM data sheet (dense
rates, 700 W).
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["PEAK_FP32", "PEAK_TF32", "HBM_BYTES_PER_S",
           "SFU_PER_CLOCK_PER_SM", "bound_ms", "operator_work",
           "operator_bound_ms"]

PEAK_FP32 = 67e12            # FLOP/s outside the tensor cores
PEAK_TF32 = 495e12           # TF32 tensor-core FLOP/s
SPLIT_TF32_PRODUCTS = 3      # TF32 products per FP32-accurate one
HBM_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16
ELEMENTWISE_FLOP = 8         # per entry: shifts, scalings, epilogue


def bound_ms(products: float = 0.0, flop: float = 0.0, nbytes: float = 0.0,
             sfu: float = 0.0, sfu_per_s: float = math.inf) -> float:
    """Least milliseconds for ``products`` FP32-accurate product FLOP,
    ``flop`` other FP32 FLOP, ``nbytes`` of device memory traffic and
    ``sfu`` special-function results."""
    return 1e3 * max(products * SPLIT_TF32_PRODUCTS / PEAK_TF32,
                     flop / PEAK_FP32, nbytes / HBM_BYTES_PER_S,
                     sfu / sfu_per_s)


def operator_work(shape: Sequence[int]) -> dict:
    """Products, other FLOP, bytes and special functions of one
    application on a grid of ``shape`` (float32 fields)."""
    n = math.prod(shape)
    return {"products": 2.0 * n * sum(shape),
            "flop": float(ELEMENTWISE_FLOP * n),
            "nbytes": 4.0 * (2 * n + sum(k * k for k in shape)),
            "sfu": 4.0 * n}


def operator_bound_ms(shape: Sequence[int], sm_count: int,
                      sm_clock_max_mhz: float) -> float:
    """Least milliseconds of one application at ``shape`` on a card of
    ``sm_count`` SMs at ``sm_clock_max_mhz``."""
    sfu_per_s = SFU_PER_CLOCK_PER_SM * sm_count * sm_clock_max_mhz * 1e6
    return bound_ms(sfu_per_s=sfu_per_s, **operator_work(shape))
