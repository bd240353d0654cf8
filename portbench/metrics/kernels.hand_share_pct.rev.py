"""Device time of the package's kernels (K4 in the batched solver) over
all device time, REV studies."""

from portbench.readers import REV, hand_share_pct


def read(traced):
    return hand_share_pct(traced, REV)
