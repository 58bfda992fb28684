from .gcy import GCY, gcy_loglinear_factory
from .ssy import SSY, ssy_loglinear_factory

__all__ = ["SSY", "ssy_loglinear_factory", "GCY", "gcy_loglinear_factory"]
