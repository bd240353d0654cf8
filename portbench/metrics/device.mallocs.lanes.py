"""The caching allocator's cudaMalloc calls per D_eff request of the
100^3 sample stream (``profiling.counters["alloc_segments"]`` over each
request)."""

from portbench.readers import DEFF
from portbench.records import counter_mean


def read(traced):
    return counter_mean(traced, DEFF, "alloc_segments")
