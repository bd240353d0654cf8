"""Milliseconds per tau request of the screening stream in the host
labelling of the percolation mask, its copies included (span
``oi/props/label_host``)."""

from portbench.readers import TAU
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, TAU, ("oi/props/label_host",))
