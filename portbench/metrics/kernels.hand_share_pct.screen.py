"""Device time of the package's kernels (K1 to K5) over all device
time, screening tau requests."""

from portbench.readers import TAU, hand_share_pct


def read(traced):
    return hand_share_pct(traced, TAU)
