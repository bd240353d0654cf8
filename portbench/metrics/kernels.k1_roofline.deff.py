"""K1's share of its bandwidth roofline in D_eff requests (see
``kernels.k1_roofline.tau``)."""

from portbench.readers import DEFF, k1_roofline


def read(traced):
    return k1_roofline(traced, DEFF)
