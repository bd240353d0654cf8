"""Milliseconds per D_eff request in the ``solve`` scopes of
``props/effective_diffusivity.py`` (the three cell problems)."""

from portbench.readers import DEFF, timing_ms


def read(traced):
    return timing_ms(traced, DEFF, ("solve",))
