"""Milliseconds per REV study in cutting and stacking the crops of its
batched groups on the host (span ``oi/props/crop``)."""

from portbench.readers import REV
from portbench.records import span_ms


def read(traced):
    return span_ms(traced, REV, ("oi/props/crop",))
