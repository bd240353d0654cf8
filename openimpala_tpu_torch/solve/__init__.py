"""Krylov solver, preconditioners and iterative refinement."""
