"""PCG steps counted per CLI run, over its three directions
(``utils/graphs.py`` stats ``reads``)."""

from portbench.readers import graph_stat

CLI = ("cli",)


def read(traced):
    return graph_stat(traced, CLI, "reads")
