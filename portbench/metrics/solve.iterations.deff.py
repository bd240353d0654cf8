"""PCG steps counted per D_eff request (``utils/graphs.py`` stats
``reads``: the three cell problems)."""

from portbench.readers import DEFF, graph_stat


def read(traced):
    return graph_stat(traced, DEFF, "reads")
