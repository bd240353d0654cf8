"""Megabytes (1e6 B) rank 0 exchanged per tau request on slabs: halo
planes sent, gathers received, all-to-all bytes sent
(``parallel.mesh.stats`` over each traced request)."""

from portbench.readers import TAU

KEYS = ("halo_bytes", "gather_bytes", "all_to_all_bytes")


def read(traced):
    if traced.kind not in TAU or not traced.answers:
        return None
    rows = [a.get("mesh") for a in traced.answers]
    if any(r is None for r in rows):
        return None
    moved = sum(r.get(k, 0) for r in rows for k in KEYS)
    return moved / 1e6 / len(rows) if moved else None
