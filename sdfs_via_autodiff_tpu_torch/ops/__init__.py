from .rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder, stationary_distribution
from .tauchen import tauchen, tauchen_P, tauchen_ladder
from .contract import lse_matmul

__all__ = [
    "rouwenhorst", "rouwenhorst_P", "rouwenhorst_ladder", "stationary_distribution",
    "tauchen", "tauchen_P", "tauchen_ladder", "lse_matmul",
]
