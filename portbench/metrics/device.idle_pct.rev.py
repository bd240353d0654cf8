"""Share of the traced window with nothing on the device, REV studies."""

from portbench.readers import REV, idle_pct


def read(traced):
    return idle_pct(traced, REV)
