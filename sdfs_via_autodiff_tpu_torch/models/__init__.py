from .ssy import SSY, ssy_loglinear_factory

__all__ = ["SSY", "ssy_loglinear_factory"]
