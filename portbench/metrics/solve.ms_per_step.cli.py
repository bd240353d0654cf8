"""Milliseconds of the CLI's ``solve`` spans (``oi/props/solve``, the
three directions) per PCG step executed (``utils/graphs.py`` stats
``steps``)."""

from portbench.records import traced_records

CLI = ("cli",)


def read(traced):
    recs = traced_records(traced, CLI)
    if recs is None:
        return None
    solve = sum(r["spans"]["oi/props/solve"][1] for r in recs
                if "oi/props/solve" in r["spans"])
    steps = sum(a["graphs"].get("steps", 0) for a in traced.answers)
    return 1e3 * solve / steps if solve > 0 and steps > 0 else None
