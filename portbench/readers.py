"""What the metric readers share: which request kinds a suffix stands for,
and means over the traced requests."""

from __future__ import annotations

from .roofline import PEAK_BYTES_S, k1_launch_bytes

TAU = ("tortuosity",)
DEFF = ("effective_diffusivity",)
REV = ("rev_study",)


def timing_ms(traced, kinds, names):
    """Mean milliseconds per request in the package's ``timings`` scopes
    ``names``; None where no request recorded any of them."""
    if traced.kind not in kinds:
        return None
    rows = [a["timings"] for a in traced.answers]
    if not any(n in t for t in rows for n in names):
        return None
    return 1e3 * sum(t.get(n, 0.0) for t in rows for n in names) / len(rows)


def graph_stat(traced, kinds, key):
    """Mean of the package's ``graphs.stats[key]`` per request."""
    if traced.kind not in kinds or not traced.answers:
        return None
    vals = [a["graphs"].get(key, 0) for a in traced.answers]
    return sum(vals) / len(vals) if any(vals) else None


def ms_per_step(traced, kinds):
    """The ``solve`` scopes' milliseconds over the PCG steps executed."""
    if traced.kind not in kinds:
        return None
    solve = sum(a["timings"].get("solve", 0.0) for a in traced.answers)
    steps = sum(a["graphs"].get("steps", 0) for a in traced.answers)
    return 1e3 * solve / steps if solve > 0 and steps > 0 else None


def k1_roofline(traced, kinds):
    """K1's compulsory bytes at the peak bandwidth over K1's device time."""
    if traced.kind not in kinds or not traced.trace.get("k1_s"):
        return None
    moved = sum(k1_launch_bytes(a["launches"]) for a in traced.answers)
    if moved <= 0:
        return None
    return 100.0 * moved / PEAK_BYTES_S / traced.trace["k1_s"]


def hand_share_pct(traced, kinds):
    """Device time of the package's own kernels over all device time."""
    if traced.kind not in kinds or not traced.trace.get("device_s"):
        return None
    return 100.0 * traced.trace["hand_s"] / traced.trace["device_s"]


def idle_pct(traced, kinds):
    """The share of the traced window in which nothing ran on the
    device."""
    if traced.kind not in kinds or not traced.trace.get("window_s"):
        return None
    return 100.0 * (1.0 - traced.trace["busy_s"] / traced.trace["window_s"])
