"""Share of the traced window with nothing on the device, tau on slabs:
each rank traces its own card, and the busy seconds are their mean over
the ranks (the window is rank 0's)."""

from portbench.readers import TAU, idle_pct


def read(traced):
    return idle_pct(traced, TAU)
