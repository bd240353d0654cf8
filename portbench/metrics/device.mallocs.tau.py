"""The caching allocator's cudaMalloc calls per tau request
(``profiling.counters["alloc_segments"]`` over each request)."""

from portbench.readers import TAU
from portbench.records import counter_mean


def read(traced):
    return counter_mean(traced, TAU, "alloc_segments")
