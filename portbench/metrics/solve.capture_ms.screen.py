"""Milliseconds per tau request of the screening stream in capturing the
PCG step's CUDA graphs and in closing them (spans ``oi/solve/capture``
and ``oi/solve/graph_close``)."""

from portbench.readers import TAU
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, TAU, ("oi/solve/capture", "oi/solve/graph_close"))
