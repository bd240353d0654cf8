"""Milliseconds of the ``solve`` scope per PCG step executed, tau on
slabs."""

from portbench.readers import TAU, ms_per_step


def read(traced):
    return ms_per_step(traced, TAU)
