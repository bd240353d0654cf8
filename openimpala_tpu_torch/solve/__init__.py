"""Krylov solver, preconditioners and iterative refinement.

Exports the names of ``openimpala_tpu/solve/__init__.py`` but two: the
functions ``cg`` and ``fgmres`` share their modules' names, and here
``solve.cg`` and ``solve.fgmres`` stay the modules (the functions are
``solve.cg.cg`` and ``solve.fgmres.fgmres``).
"""

from .cg import ResidualHistory, SolveResult, jacobi_preconditioner
from .preconditioners import make_multigrid_preconditioner
from .refine import solve_system

__all__ = [
    "ResidualHistory",
    "SolveResult",
    "jacobi_preconditioner",
    "solve_system",
    "make_multigrid_preconditioner",
]
