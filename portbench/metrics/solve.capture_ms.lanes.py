"""Milliseconds per D_eff request of the 100^3 sample stream in capturing
the lanes' PCG step as CUDA graphs and in closing them (spans
``oi/solve/capture`` and ``oi/solve/graph_close``)."""

from portbench.readers import DEFF
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, DEFF,
                   ("oi/solve/capture", "oi/solve/graph_close"))
