"""Milliseconds per screening tau request in the ``solve`` scope of
``props/tortuosity.py``."""

from portbench.readers import TAU, timing_ms


def read(traced):
    return timing_ms(traced, TAU, ("solve",))
