"""Device time of the package's kernels (K1 to K5) over all device
time, D_eff requests of the 100^3 sample stream."""

from portbench.readers import DEFF, hand_share_pct


def read(traced):
    return hand_share_pct(traced, DEFF)
