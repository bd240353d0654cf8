"""Device time of the package's kernels (K1 to K5) over all device
time of rank 0's card, tau requests on slabs."""

from portbench.readers import TAU, hand_share_pct


def read(traced):
    return hand_share_pct(traced, TAU)
