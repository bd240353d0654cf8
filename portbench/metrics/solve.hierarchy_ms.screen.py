"""Milliseconds per tau request of the screening stream in building the
preconditioner's hierarchy (span ``oi/solve/hierarchy_build``)."""

from portbench.readers import TAU
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, TAU, ("oi/solve/hierarchy_build",))
