"""Tracing and profiling (counterpart of
``openimpala_tpu/utils/profiling.py``; reference AMReX ``BL_PROFILE``
scopes and ``amrex::second()`` wall clocks, ``TortuosityHypre.cpp:250,303,
399,564,655,897,1002``, ``Diffusion.cpp:176,737-740``).

* ``phase_timer(timings, name, device)``: a named scope, the one span API
  of the package.  It adds its wall seconds to the caller's ``timings``
  dict (when one is passed; on a CUDA ``device`` the scope is then
  bracketed by synchronisations, so its time covers the device work it
  queued) and to the process-wide per-phase table (when profiling is
  enabled: ``OPENIMPALA_PROFILE=1`` at import, or ``enable(True)``;
  ``report()`` prints it, ``reset()`` clears it).  While a
  ``torch.profiler`` records, the scope is also a ``record_function``
  range named ``oi/<layer>/<name>`` (a ``name`` without a layer is in
  ``props``), so the device trace shows each span on its own clock, and
  ``torch.autograd.profiler.emit_nvtx()`` turns the ranges into NVTX
  ranges for ``nsys``.  With no ``timings``, profiling off and no
  profiler recording, a scope costs one boolean test.
* ``request(entry)``: the decorator of the public entry points.  A call
  from outside any other is a request: its root span is
  ``oi/request/<entry>#<n>`` (``n`` counts the process's requests), and
  its spans nest under it, thread by thread.  A call made inside another
  entry point is a child span, ``oi/props/<entry>``.  While a profiler
  records or profiling is enabled, each request closed leaves a record
  in ``requests``: its seconds, the calls and seconds of each span under
  it, and what ``counters`` gained over it.
* ``counters``: ``fill_rounds``, the rounds of every packed percolation
  fill (``ops/packfill.py``, counted always); ``device_pages``, the TIFF
  pages thresholded on a device (``io/tiff.py::TiffReader.
  threshold_tensor``, counted always); ``alloc_segments``, the
  caching allocator's ``cudaMalloc`` calls (``segment.all.allocated``)
  over each request, read only while a profiler records or profiling is
  enabled.  ``reset_counters()`` clears them.
* ``device_trace(logdir)``: ``torch.profiler`` over the block (CPU and,
  where there is a card, CUDA activities), written as a Chrome trace into
  ``logdir``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _prof

_ENABLED = os.environ.get("OPENIMPALA_PROFILE", "0") == "1"
_TABLE: dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [calls, s]

counters: collections.Counter = collections.Counter()
# one record per request closed while a profiler recorded or profiling was
# enabled, newest last
requests: collections.deque = collections.deque(maxlen=256)
_local = threading.local()  # .request: the record of this thread's request
_ordinal = itertools.count(1)
_NULL = contextlib.nullcontext()
# the counters counted always, whose gain over a request its record keeps
_GAINED = ("fill_rounds", "device_pages")


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = bool(on)


def reset_counters():
    counters.clear()


class _Span:
    """An open scope (``phase_timer``, ``request``, ``root``)."""

    __slots__ = ("name", "key", "timings", "device", "range", "t0")

    def __init__(self, name, key, timings=None, device=None):
        self.name, self.key = name, key
        self.timings, self.device = timings, device
        self.range = None

    def __enter__(self):
        if _prof._is_profiler_enabled:
            self.range = _prof.record_function(self.name)
            self.range.__enter__()
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            self._sync()
            dt = time.perf_counter() - self.t0
            if self.timings is not None:
                self.timings[self.key] = self.timings.get(self.key, 0.0) + dt
            if _ENABLED:
                row = _TABLE[self.key]
                row[0] += 1
                row[1] += dt
            self._close(dt)
        finally:
            if self.range is not None:
                self.range.__exit__(*exc)

    def _sync(self):
        # a timed scope covers the device work it queued
        if (self.device is not None
                and (self.timings is not None or _ENABLED)
                and torch.device(self.device).type == "cuda"):
            torch.cuda.synchronize(self.device)

    def _close(self, dt):
        record = getattr(_local, "request", None)
        if record is not None:
            row = record["spans"].setdefault(self.name, [0, 0.0])
            row[0] += 1
            row[1] += dt


class _Request(_Span):
    """A public entry point's call: a request's root where no request is
    open on this thread, else a child span."""

    __slots__ = ("record", "before")

    def __init__(self, entry: str):
        self.record = None
        if getattr(_local, "request", None) is not None:
            super().__init__(f"oi/props/{entry}", entry)
            return
        n = next(_ordinal)
        super().__init__(f"oi/request/{entry}#{n}", f"request/{entry}")
        self.record = {"entry": entry, "ordinal": n, "s": 0.0, "spans": {},
                       "counters": {}}

    def __enter__(self):
        if self.record is not None:
            self.before = {k: counters[k] for k in _GAINED}
            self.before["alloc_segments"] = _alloc_segments()
            _local.request = self.record
        return super().__enter__()

    def _close(self, dt):
        if self.record is None:
            super()._close(dt)
            return
        _local.request = None
        gained = {k: counters[k] - self.before[k] for k in _GAINED}
        gained["alloc_segments"] = (_alloc_segments()
                                    - self.before["alloc_segments"])
        counters["alloc_segments"] += gained["alloc_segments"]
        self.record.update(s=dt, counters=gained)
        requests.append(self.record)


def _alloc_segments() -> int:
    """The caching allocator's ``cudaMalloc`` calls so far on the current
    device (0 where CUDA is not started)."""
    if not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_stats().get("segment.all.allocated", 0))


def phase_timer(timings: dict | None, name: str, device=None):
    """A scope named ``name`` (module docstring): its wall seconds go to
    ``timings[name]`` (when ``timings`` is a dict; synchronised on a CUDA
    ``device``) and to the per-phase table (when profiling is enabled);
    while a profiler records it is the range ``oi/<name>``, or
    ``oi/props/<name>`` where ``name`` names no layer."""
    if timings is None and not (_ENABLED or _prof._is_profiler_enabled):
        return _NULL
    span = f"oi/{name}" if "/" in name else f"oi/props/{name}"
    return _Span(span, name, timings, device)


def request(entry: str):
    """Decorate the public entry point ``entry`` (module docstring)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_ENABLED or _prof._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Request(entry):
                return fn(*args, **kwargs)
        return call
    return wrap


def root(name: str):
    """A root span ``oi/<name>`` of work that is no request (the solver
    warm-up's thread); it leaves no record."""
    if not (_ENABLED or _prof._is_profiler_enabled):
        return _NULL
    return _Span(f"oi/{name}", name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` over the block (CPU activities, and CUDA ones
    where there is a card); the trace is written into ``logdir`` as a
    Chrome trace (``trace_<pid>_<n>.json``; chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{n}.json"))


def report(file=None) -> str:
    """TinyProfiler-style per-phase table (name, calls, total s, mean ms),
    the layout of the JAX package's ``report``."""
    lines = [f"{'phase':<40} {'calls':>6} {'total_s':>10} {'mean_ms':>10}"]
    for name, (calls, secs) in sorted(_TABLE.items(), key=lambda kv: -kv[1][1]):
        mean_ms = 1e3 * secs / calls if calls else 0.0
        lines.append(f"{name:<40} {calls:>6} {secs:>10.3f} {mean_ms:>10.2f}")
    out = "\n".join(lines)
    if file is not None:
        print(out, file=file, flush=True)
    return out


def reset():
    _TABLE.clear()
