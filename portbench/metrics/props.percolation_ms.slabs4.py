"""Milliseconds per tau request in the ``percolation_mask`` scope of
``props/tortuosity.py`` on slabs: the slab's upload and the packed fill
with its exchanges of planes between the ranks (rank 0's clock)."""

from portbench.readers import TAU, timing_ms


def read(traced):
    return timing_ms(traced, TAU, ("percolation_mask",))
