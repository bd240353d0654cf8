"""Milliseconds per CLI run in the ``solve`` span of
``props/tortuosity.py`` (the PCG solves in float64 refinement), over
the three directions."""

from portbench.records import span_ms

CLI = ("cli",)


def read(traced):
    return span_ms(traced, CLI, ("oi/props/solve",))
