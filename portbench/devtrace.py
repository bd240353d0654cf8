"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read: the traced window, the device's busy time as the union of
its kernel, copy and set intervals over every stream, device time by
operation, and the idle gaps named by the host range open in them.

The window is the span of the ``portbench.answer`` ranges the harness
opens around each traced request.  A host range also appears on the
device's timeline (its span there); such copies, and the profiler's own
buffer requests, are no device work and are left out by name.  The raw events are read from the
profiler's Kineto result (no event tree is built: that costs minutes on a
trace of many thousands of kernels).
"""

from __future__ import annotations

import collections
import contextlib

ANSWER = "portbench.answer"
# every kernel of the package's csrc/ (K1 to K5 and the dot's reduction)
HAND = ("k1_planes", "k1_restrict", "k1_stream", "k2_cells", "k3_cells",
        "k4_planes", "k5_stream", "reduce_partials")
K1 = ("k1_planes", "k1_restrict", "k1_stream")
PROFILER = "Activity Buffer Request"


def _ns(e, which):
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _end_ns(e):
    return _ns(e, "start") + _ns(e, "duration")


def _on_device(e) -> bool:
    return "cuda" in str(e.device_type()).lower()


def _union(spans):
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


@contextlib.contextmanager
def traced():
    """``torch.profiler`` over the block (CPU and CUDA activities); yields
    a dict that holds the reduction once the block has closed."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    out.update(reduce(prof.profiler.kineto_results.events()))


def reduce(events, top: int = 10) -> dict:
    answers, host, dev = [], [], []
    for e in events:
        row = (_ns(e, "start"), _end_ns(e), e.name())
        if _on_device(e):
            dev.append(row)
        elif e.name() == ANSWER:
            answers.append(row[:2])
        else:
            host.append(row)
    if not answers:
        return {}
    # a host range's copy on the device's timeline is no device work, nor
    # is the profiler's own buffer request
    ranges = {n for _, _, n in host} | {ANSWER, PROFILER}
    dev = [d for d in dev if d[2] not in ranges]
    w0, w1 = min(a for a, _ in answers), max(b for _, b in answers)
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    by_name = collections.Counter()
    for a, b, n in inside:
        by_name[n] += (b - a) / 1e9
    merged = _union([(a, b) for a, b, _ in inside])
    busy = sum(b - a for a, b in merged) / 1e9
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_open_at(host, (a + b) // 2), (b - a) / 1e9]
             for a, b in gaps[:top]]
    device_s = sum(by_name.values())
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy,
        "device_s": device_s,
        "hand_s": sum(s for n, s in by_name.items()
                      if any(h in n for h in HAND)),
        "k1_s": sum(s for n, s in by_name.items()
                    if any(h in n for h in K1)),
        "device_ops": [[n[:160], s] for n, s in by_name.most_common(top)],
        "idle_gaps": named,
    }


def _open_at(host, t) -> str:
    """The innermost host range open at ``t`` (the latest to start); where
    none is, the last to have closed before it."""
    best = last = None
    for a, b, n in host:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, n)
        elif b <= t and (last is None or b > last[0]):
            last = (b, n)
    if best is not None:
        return best[1][:160]
    return f"after {last[1][:154]}" if last else "(no host range)"
