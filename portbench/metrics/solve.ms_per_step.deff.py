"""Milliseconds of the ``solve`` scopes per PCG step executed, D_eff."""

from portbench.readers import DEFF, ms_per_step


def read(traced):
    return ms_per_step(traced, DEFF)
