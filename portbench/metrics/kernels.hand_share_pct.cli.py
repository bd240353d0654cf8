"""Device time of the package's kernels (K1 to K5) over all device
time, CLI runs."""

from portbench.readers import hand_share_pct

CLI = ("cli",)


def read(traced):
    return hand_share_pct(traced, CLI)
