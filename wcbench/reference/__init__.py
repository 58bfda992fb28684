"""Plain reference of the discrete Koopmans operator, its solves and the
control.

Written from the model equations in plain PyTorch, apart from the
program under test: it imports neither JAX nor either package of this
repository.  ``ssy`` and ``gcy`` build each model's per-axis chain (its
own Tauchen discretization, ``tauchen``; ``models.build_chain`` finds
the module by the model's name), ``chain`` applies and linearizes the
operator in log space, ``solve`` runs Newton-Krylov and successive
approximation on it.  ``precision="float64"`` is the reference;
``precision="tf32"`` is the control: float32 with every product's
operands rounded to TF32, the step below the program's FP32-accurate
products.
"""

from .chain import PRECISIONS, KoopmansChain
from .models import build_chain
from .solve import newton, successive_approx

__all__ = ["PRECISIONS", "KoopmansChain", "build_chain",
           "newton", "successive_approx"]
