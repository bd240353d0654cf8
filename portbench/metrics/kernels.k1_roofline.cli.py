"""K1's share of its bandwidth roofline in CLI runs: the compulsory
bytes of every K1 launch (``stencil_cuda.launches_route_at`` times
``roofline.k1_bytes``) at 3.35e12 B/s over K1's device time in the
trace."""

from portbench.readers import k1_roofline

CLI = ("cli",)


def read(traced):
    return k1_roofline(traced, CLI)
