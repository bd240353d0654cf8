"""Batched PCG steps counted per REV study (``utils/graphs.py`` stats
``reads``: the lockstep steps of each size's batch)."""

from portbench.readers import REV, graph_stat


def read(traced):
    return graph_stat(traced, REV, "reads")
