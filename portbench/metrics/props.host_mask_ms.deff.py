"""Milliseconds per D_eff request in the mask and count of a host volume
(span ``oi/props/host_mask``)."""

from portbench.readers import DEFF
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, DEFF, ("oi/props/host_mask",))
