"""Width-1 ghost layers around a volume, periodic or clamped (the
single-device form of AMReX ``FillBoundary``, reference
``src/props/TortuosityHypre.cpp:584-585``)."""

from __future__ import annotations

import torch


def pad_halo(x: torch.Tensor, periodic) -> torch.Tensor:
    """Pad a (X, Y, Z) tensor to (X+2, Y+2, Z+2); leading dimensions (a
    batch of volumes) pass through unpadded.

    Periodic axes wrap; clamped axes are zero-filled, which encodes the
    reference's "outside the domain = inactive / no-flux" convention.
    Built from ``torch.cat`` (``F.pad(mode="circular")`` wants a 5-D input
    for 3-D padding).
    """
    lead = x.dim() - 3
    for axis, per in enumerate(periodic, start=lead):
        n = x.shape[axis]
        if per:
            lo, hi = x.narrow(axis, n - 1, 1), x.narrow(axis, 0, 1)
        else:
            shape = list(x.shape)
            shape[axis] = 1
            lo = hi = torch.zeros(shape, dtype=x.dtype, device=x.device)
        x = torch.cat([lo, x, hi], dim=axis)
    return x
