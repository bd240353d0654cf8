"""Share of the traced window with nothing on the device, D_eff
requests of the 100^3 sample stream."""

from portbench.readers import DEFF, idle_pct


def read(traced):
    return idle_pct(traced, DEFF)
