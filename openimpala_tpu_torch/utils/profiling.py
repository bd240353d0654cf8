"""Per-step wall-clock timing for the drivers (opt-in: no cost, and no
device synchronisation, unless the caller passes a ``timings`` dict)."""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def phase_timer(timings: dict | None, name: str, device=None):
    """Add the wall seconds of the block to ``timings[name]``.  On a CUDA
    ``device`` the block is bracketed by synchronisations, so the time
    covers the device work it queued."""
    if timings is None:
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
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
