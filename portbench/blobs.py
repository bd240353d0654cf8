"""Two-phase blobs volumes made on the device from a seed.

The recipe is upstream's sample structure (``data/create_sample_structure.py``,
as the repository's ``make_blobs`` restates it): Gaussian noise on a grid
of ``max(2, n // 8)`` points per axis, upsampled by linear interpolation
along each axis in turn, and cut at the porosity quantile.  Here the
noise comes from a ``torch.Generator`` on the device and the cut is the
``k``-th smallest value, so exactly ``round(porosity * n^3)`` cells are
pore (1) and the rest solid (0).
"""

from __future__ import annotations

import numpy as np
import torch


def seed_of(*words) -> int:
    """A 63-bit generator seed from whole numbers of any size (the run's
    seed, a stream number, an index)."""
    hi, lo = np.random.SeedSequence(
        [int(w) % 2 ** 64 for w in words]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def blobs(n: int, porosity: float, seed: int, device) -> torch.Tensor:
    """(n, n, n) uint8 volume on ``device``: 1 = pore, 0 = solid."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    coarse = max(2, n // 8)
    field = torch.randn((coarse,) * 3, generator=gen, device=device,
                        dtype=torch.float32)
    for axis in range(3):
        src = field.shape[axis]
        pos = torch.linspace(0, src - 1, n, dtype=torch.float64,
                             device=device)
        i0 = pos.to(torch.int64).clamp(0, src - 2)
        t = (pos - i0).to(torch.float32).reshape(
            [-1 if a == axis else 1 for a in range(3)])
        lo = field.index_select(axis, i0)
        hi = field.index_select(axis, i0 + 1)
        field = lo * (1 - t) + hi * t
    k = int(round(porosity * n ** 3))
    if k <= 0:
        return torch.zeros((n,) * 3, dtype=torch.uint8, device=device)
    thr = torch.kthvalue(field.flatten(), k).values
    return (field <= thr).to(torch.uint8)
