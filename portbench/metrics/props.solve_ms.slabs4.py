"""Milliseconds per tau request in the ``solve`` scope of
``props/tortuosity.py`` on slabs (rank 0's clock)."""

from portbench.readers import TAU, timing_ms


def read(traced):
    return timing_ms(traced, TAU, ("solve",))
