"""Milliseconds of the ``solve`` scopes per lockstep PCG step executed,
D_eff requests of the 100^3 sample stream."""

from portbench.readers import DEFF, ms_per_step


def read(traced):
    return ms_per_step(traced, DEFF)
