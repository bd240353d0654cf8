"""K1's share of its bandwidth roofline in tau requests on slabs, rank 0:
the compulsory bytes of its K1 launches on the slab layout
(``stencil_cuda.launches_route_at`` times ``roofline.k1_bytes``) at
3.35e12 B/s over K1's device time in rank 0's trace."""

from portbench.readers import TAU, k1_roofline


def read(traced):
    return k1_roofline(traced, TAU)
