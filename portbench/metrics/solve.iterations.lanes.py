"""Lockstep PCG steps counted per D_eff request of the 100^3 sample stream
(``utils/graphs.py`` stats ``reads``: one host read of the lanes' probe a
step, so the slowest lane's count)."""

from portbench.readers import DEFF, graph_stat


def read(traced):
    return graph_stat(traced, DEFF, "reads")
