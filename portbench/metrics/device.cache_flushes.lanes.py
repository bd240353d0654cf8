"""The caching allocator's cache flushes in the measured window of the
100^3 sample stream of D_eff: each costs seconds, and how many a window holds
depends on how many requests it completes (the graphs' pools of every
request stay cached until the card is full)."""

from portbench.readers import DEFF


def read(traced):
    w = getattr(traced, "window", None)
    if traced.kind not in DEFF or w is None or w.flushes is None:
        return None
    return w.flushes
