"""Milliseconds per tau request in the percolation scopes of
``props/tortuosity.py`` (the volume's upload, the mask, its upload)."""

from portbench.readers import TAU, timing_ms


def read(traced):
    return timing_ms(traced, TAU, ("phase_upload", "percolation_mask",
                                   "mask_upload"))
