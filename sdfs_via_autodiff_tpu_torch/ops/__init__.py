from .rouwenhorst import rouwenhorst, rouwenhorst_P, rouwenhorst_ladder, stationary_distribution
from .tauchen import tauchen, tauchen_P, tauchen_ladder
from .contract import lse_matmul
from .quadrature import gauss_hermite_normal, tensor_quadrature_normal
from .grids import build_grid_ssy, build_grid_gcy, flatten_mesh
from .interp import uniform_grid_coords, multilinear_interp, lin_interp

__all__ = [
    "rouwenhorst", "rouwenhorst_P", "rouwenhorst_ladder", "stationary_distribution",
    "tauchen", "tauchen_P", "tauchen_ladder", "lse_matmul",
    "gauss_hermite_normal", "tensor_quadrature_normal", "build_grid_ssy",
    "build_grid_gcy", "flatten_mesh", "uniform_grid_coords",
    "multilinear_interp", "lin_interp",
]
