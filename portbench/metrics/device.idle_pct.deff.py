"""Share of the traced window with nothing on the device, D_eff
requests."""

from portbench.readers import DEFF, idle_pct


def read(traced):
    return idle_pct(traced, DEFF)
