"""Tracing and profiling (counterpart of
``openimpala_tpu/utils/profiling.py``; reference AMReX ``BL_PROFILE``
scopes and ``amrex::second()`` wall clocks, ``TortuosityHypre.cpp:250,303,
399,564,655,897,1002``, ``Diffusion.cpp:176,737-740``).

Two tiers:

* ``phase_timer(timings, name, device)``: a named scope.  It adds its wall
  seconds to the caller's ``timings`` dict (when one is passed) and to the
  process-wide per-phase table (when profiling is enabled:
  ``OPENIMPALA_PROFILE=1`` at import, or ``enable(True)``; ``report()``
  prints it, ``reset()`` clears it).  On a CUDA ``device`` a timed scope is
  bracketed by synchronisations, so its time covers the device work it
  queued.  On a machine with a card every scope is also an NVTX range,
  which a device trace shows as the phase's span (the counterpart of
  ``jax.named_scope``).  With no ``timings``, profiling off and no card,
  the scope costs nothing.
* ``device_trace(logdir)``: ``torch.profiler`` over the block (CPU and,
  where there is a card, CUDA activities), written as a Chrome trace into
  ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_ENABLED = os.environ.get("OPENIMPALA_PROFILE", "0") == "1"
_TABLE: dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [calls, s]


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = bool(on)


@contextlib.contextmanager
def phase_timer(timings: dict | None, name: str, device=None):
    """Add the wall seconds of the block to ``timings[name]`` (when
    ``timings`` is a dict) and to the per-phase table (when profiling is
    enabled); mark it as an NVTX range where the machine has a card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if timings is None and not _ENABLED:
            yield
            return
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if timings is not None:
                timings[name] = timings.get(name, 0.0) + dt
            if _ENABLED:
                row = _TABLE[name]
                row[0] += 1
                row[1] += dt
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
