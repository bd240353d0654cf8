"""Collectives of rank 0 per PCG step, tau on slabs: the halo exchanges,
gathers (every sum, maximum and minimum over the ranks is one) and
all-to-alls of ``parallel.mesh.stats`` over each traced request, the
percolation's and the set-up's included, over the steps it executed."""

from portbench.readers import TAU

KEYS = ("halo_exchanges", "gathers", "all_to_alls")


def read(traced):
    if traced.kind not in TAU or not traced.answers:
        return None
    rows = [a.get("mesh") for a in traced.answers]
    steps = sum(a["graphs"].get("steps", 0) for a in traced.answers)
    if any(r is None for r in rows) or steps <= 0:
        return None
    count = sum(r.get(k, 0) for r in rows for k in KEYS)
    return count / steps if count else None
