"""Milliseconds per CLI run in the percolation spans of
``props/tortuosity.py`` (the volume's upload, the mask, its upload),
over the three directions."""

from portbench.records import span_ms

CLI = ("cli",)


def read(traced):
    return span_ms(traced, CLI, ("oi/props/phase_upload",
                                 "oi/props/percolation_mask",
                                 "oi/props/mask_upload"))
