"""PCG steps counted per screening tau request (``utils/graphs.py``
stats ``reads``)."""

from portbench.readers import TAU, graph_stat


def read(traced):
    return graph_stat(traced, TAU, "reads")
