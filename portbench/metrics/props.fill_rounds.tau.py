"""Packed percolation fill rounds per tau request, both stages of the
double fill (``profiling.counters["fill_rounds"]`` over each request)."""

from portbench.readers import TAU
from portbench.records import counter_mean


def read(traced):
    return counter_mean(traced, TAU, "fill_rounds")
