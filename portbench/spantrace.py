#!/usr/bin/env python3
"""Where the device's idle time falls among the program's spans, and K2's
and K4's device time.

``reduce(events)`` takes the same profiler events as ``devtrace.reduce``
and the same window (the ``portbench.answer`` ranges), and returns:

* ``spans``: for each ``oi/`` range of the package (a request's root with
  its ordinal ``#<n>`` stripped), its ``calls``, ``host_s``, ``self_s``
  (less the ``oi/`` spans inside it) and ``idle_s``: the window's idle
  time (no kernel, copy or set on any stream) that fell while the span
  was the innermost ``oi/`` span open on the requests' thread;
* ``unspanned_idle_s``: idle inside a request's root under no child span;
  ``outside_idle_s``: idle in the window under no ``oi/`` span at all
  (the caller's time between requests); ``idle_s``: all the window's;
* ``k2_s``, ``k4_s``: the device time of K2 and K4 in the window;
* ``requests_s``: each request's root span, seconds, in order.

Run as a script, it runs one cell as ``run.py`` does (the same arguments)
with the two reductions and writes the above into ``--out``, with K2's
and K4's launches over the traced requests (``stencil_cuda.launches_at``)
and their rooflines (``roofline_k2_k4.py``):

    python3 portbench/spantrace.py --out spans.json --workload <name> \\
        --seed <n> --seconds <s> --trace 1
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    _HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path = [os.path.dirname(_HERE)] + [
        p for p in sys.path if os.path.abspath(p or ".") != _HERE]

from portbench import devtrace  # noqa: E402

K2 = ("k2_cells",)
K4 = ("k4_planes",)
SPAN = "oi/"


def _thread(e) -> int:
    f = getattr(e, "start_thread_id", None)
    return int(f()) if f is not None else 0


def _innermost(spans):
    """The segments of one thread's nested ``(start, end, name)`` spans
    in which each is the innermost open: ``(start, end, name)``, in order."""
    segs, stack = [], []  # stack: [end, name, cursor]

    def close():
        end, name, cursor = stack.pop()
        if end > cursor:
            segs.append((cursor, end, name))
        if stack:
            stack[-1][2] = max(stack[-1][2], end)

    for a, b, n in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            close()
        if stack:
            b = min(b, stack[-1][0])
            if a > stack[-1][2]:
                segs.append((stack[-1][2], a, stack[-1][1]))
        stack.append([b, n, a])
    while stack:
        close()
    return segs


def _overlap(segs, gaps):
    """Per name, the time of ``gaps`` inside the segments that name
    (both sorted and disjoint)."""
    out = collections.Counter()
    j = 0
    for a, b, n in segs:
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            out[n] += min(b, gaps[k][1]) - max(a, gaps[k][0])
            k += 1
    return out


def _key(name: str) -> str:
    return name.split("#", 1)[0]


def reduce(events) -> dict:
    answers, names, dev, spans = [], set(), [], []
    for e in events:
        a, b, n = devtrace._ns(e, "start"), devtrace._end_ns(e), e.name()
        if devtrace._on_device(e):
            dev.append((a, b, n))
        elif n == devtrace.ANSWER:
            answers.append((a, b, _thread(e)))
        else:
            names.add(n)
            if n.startswith(SPAN):
                spans.append((a, b, n, _thread(e)))
    if not answers:
        return {}
    names |= {devtrace.ANSWER, devtrace.PROFILER}
    w0, w1 = min(a for a, _, _ in answers), max(b for _, b, _ in answers)
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if n not in names and b > w0 and a < w1]
    gaps, prev = [], w0
    for a, b in devtrace._union([(a, b) for a, b, _ in inside]):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    main = collections.Counter(t for _, _, t in answers).most_common(1)[0][0]

    stats = {}
    for a, b, n, _ in spans:
        row = stats.setdefault(_key(n), {"calls": 0, "host_s": 0.0,
                                         "self_s": 0.0, "idle_s": 0.0})
        row["calls"] += 1
        row["host_s"] += (b - a) / 1e9
    idle = collections.Counter()
    for t in {t for *_, t in spans}:
        segs = _innermost([(a, b, n) for a, b, n, u in spans if u == t])
        for a, b, n in segs:
            stats[_key(n)]["self_s"] += (b - a) / 1e9
        if t == main:
            idle = _overlap(segs, gaps)
    for n, ns in idle.items():
        stats[_key(n)]["idle_s"] += ns / 1e9
    idle_s = sum(b - a for a, b in gaps) / 1e9
    spanned = sum(idle.values()) / 1e9
    return {
        "spans": stats,
        "idle_s": idle_s,
        "unspanned_idle_s": sum(r["idle_s"] for n, r in stats.items()
                                if n.startswith("oi/request/")),
        "outside_idle_s": idle_s - spanned,
        "k2_s": sum(b - a for a, b, n in inside
                    if any(k in n for k in K2)) / 1e9,
        "k4_s": sum(b - a for a, b, n in inside
                    if any(k in n for k in K4)) / 1e9,
        "requests_s": [(b - a) / 1e9 for a, b, n, _ in sorted(spans)
                       if n.startswith("oi/request/")],
    }


def main(argv=None) -> int:
    from portbench import harness, roofline, roofline_k2_k4
    from openimpala_tpu_torch.ops import stencil_cuda
    from torch.autograd import profiler

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    args, rest = ap.parse_known_args(argv)
    found, launches, seen = {}, collections.Counter(), []
    reduce_cell, reset = devtrace.reduce, stencil_cuda.reset_counts

    def reset_counts():
        # the harness resets before each traced request: what the counter
        # holds then is the last request's (or, the first time, the
        # untraced window's)
        if profiler._is_profiler_enabled:
            if seen:
                launches.update(stencil_cuda.launches_at)
            seen.append(1)
        reset()

    def reduce_both(events, top=10):
        launches.update(stencil_cuda.launches_at)
        found.update(reduce(events))
        return reduce_cell(events, top)

    devtrace.reduce, stencil_cuda.reset_counts = reduce_both, reset_counts
    rc = harness.main(T0, rest)
    for k in ("k2", "k4"):
        moved = roofline_k2_k4.launch_bytes(launches, k)
        found[f"{k}_bytes"] = moved
        if found.get(f"{k}_s"):
            found[f"{k}_roofline"] = (100.0 * moved / roofline.PEAK_BYTES_S
                                      / found[f"{k}_s"])
    found["launches_at"] = {f"{n} {'x'.join(map(str, s))}": c
                            for (n, s), c in sorted(launches.items())}
    found["traced_requests"] = len(seen)
    with open(args.out, "w") as f:
        json.dump(found, f, indent=1, sort_keys=True)
    print(f"spantrace: idle {found.get('idle_s')} s, unspanned "
          f"{found.get('unspanned_idle_s')} s, outside "
          f"{found.get('outside_idle_s')} s; K2 "
          f"{found.get('k2_roofline')} %, K4 {found.get('k4_roofline')} %",
          file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    _CACHE = os.path.join(os.path.dirname(_HERE), ".portbench_cache")
    for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                       ("TRITON_CACHE_DIR", "triton"),
                       ("CUDA_CACHE_PATH", "cuda")):
        os.environ[_var] = os.path.join(_CACHE, _sub)
    sys.exit(main())
