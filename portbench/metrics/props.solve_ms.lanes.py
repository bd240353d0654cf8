"""Milliseconds per D_eff request of the 100^3 sample stream in the ``solve``
scopes of ``props/effective_diffusivity.py`` (the three cell problems as
lockstep lanes: one scope a request)."""

from portbench.readers import DEFF, timing_ms


def read(traced):
    return timing_ms(traced, DEFF, ("solve",))
