"""Share of the traced window with nothing on the device (the union
of kernel and copy intervals over every stream), tau requests."""

from portbench.readers import TAU, idle_pct


def read(traced):
    return idle_pct(traced, TAU)
