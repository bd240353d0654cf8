"""Synthetic two-phase volumes made with numpy from a seed (the repo's
sample-data recipe, ``scripts/make_sample_data.py::make_blobs``)."""

from __future__ import annotations

import numpy as np


def make_blobs(n: int, porosity: float, seed: int = 0) -> np.ndarray:
    """(X,Y,Z) uint8 volume: 1 = pore (fraction ~= porosity), 0 = solid.
    Coarse Gaussian noise, trilinearly upsampled, thresholded at the
    porosity quantile."""
    rng = np.random.default_rng(seed)
    coarse = max(2, n // 8)
    field = rng.standard_normal((coarse,) * 3)
    for axis in range(3):
        src = field.shape[axis]
        pos = np.linspace(0, src - 1, n)
        i0 = np.clip(pos.astype(int), 0, src - 2)
        t = (pos - i0).reshape([-1 if a == axis else 1 for a in range(3)])
        lo = np.take(field, i0, axis=axis)
        hi = np.take(field, i0 + 1, axis=axis)
        field = lo * (1 - t) + hi * t
    thr = np.quantile(field, porosity)
    return (field < thr).astype(np.uint8)
