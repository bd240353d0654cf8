"""Milliseconds per CLI run in reading and thresholding the TIFF stack
(span ``oi/cli/read_threshold`` of ``diffusion.py``)."""

from portbench.records import span_ms

CLI = ("cli",)


def read(traced):
    return span_ms(traced, CLI, ("oi/cli/read_threshold",))
