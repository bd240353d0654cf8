"""The caching allocator's cudaMalloc calls per CLI run
(``profiling.counters["alloc_segments"]`` over each request)."""

from portbench.records import counter_mean

CLI = ("cli",)


def read(traced):
    return counter_mean(traced, CLI, "alloc_segments")
