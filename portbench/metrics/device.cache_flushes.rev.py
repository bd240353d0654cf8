"""The caching allocator's cache flushes in the measured window of the REV
studies: each costs seconds, and whether a window holds one depends on how
many studies it completes (the graphs' pools of every study stay cached
until the card is full)."""

from portbench.readers import REV


def read(traced):
    w = getattr(traced, "window", None)
    if traced.kind not in REV or w is None or w.flushes is None:
        return None
    return w.flushes
