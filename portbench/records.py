"""What the readers of the program's own spans and counters share.

The package keeps a record of each request that closed while a profiler
recorded (``openimpala_tpu_torch/utils/profiling.py``: ``requests``, newest
last): the calls and seconds of each ``oi/`` span under the request's root,
and what its counters gained over it.  The traced sub-window's requests
are the last ones recorded before the readers run.  A version of the
package that keeps no records gives every reader nothing to read.
"""

from __future__ import annotations


def traced_records(traced, kinds):
    """The records of the traced requests, oldest first; None where the
    cell's kind is not in ``kinds``, nothing was traced, or the package
    kept fewer records of that kind than there are traced requests."""
    if traced.kind not in kinds or not traced.trace or not traced.answers:
        return None
    try:
        from openimpala_tpu_torch.utils import profiling
    except ImportError:
        return None
    recs = [r for r in list(getattr(profiling, "requests", ()))
            if isinstance(r, dict) and r.get("entry") == traced.kind]
    n = len(traced.answers)
    return recs[-n:] if len(recs) >= n else None


def span_ms(traced, kinds, names):
    """Mean milliseconds per request in the spans ``names`` (their full
    ``oi/`` names); None where no traced request opened any of them."""
    recs = traced_records(traced, kinds)
    if recs is None or not any(n in r["spans"] for r in recs
                               for n in names):
        return None
    return 1e3 * sum(r["spans"][n][1] for r in recs for n in names
                     if n in r["spans"]) / len(recs)


def counter_mean(traced, kinds, key):
    """Mean per request of what the counter ``key`` gained over each
    traced request."""
    recs = traced_records(traced, kinds)
    if recs is None or any(key not in r["counters"] for r in recs):
        return None
    return sum(r["counters"][key] for r in recs) / len(recs)
