"""PCG steps per tau request on slabs (``utils/graphs.py`` stats
``reads``: a slab solve runs its steps eagerly and reads each)."""

from portbench.readers import TAU, graph_stat


def read(traced):
    return graph_stat(traced, TAU, "reads")
