"""The caching allocator's cudaMalloc calls per REV study
(``profiling.counters["alloc_segments"]`` over each request)."""

from portbench.readers import REV
from portbench.records import counter_mean


def read(traced):
    return counter_mean(traced, REV, "alloc_segments")
