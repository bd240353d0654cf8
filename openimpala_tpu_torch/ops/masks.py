"""Mask and field construction helpers."""

from __future__ import annotations

import torch


def phase_mask(phase, phase_id: int):
    """Boolean mask of cells belonging to ``phase_id`` (reference
    ``EffectiveDiffusivityHypre.cpp:213-323``, ``Diffusion.cpp:520-530``)."""
    return phase == phase_id


def linear_ramp(shape, direction: int, vlo: float, vhi: float,
                dtype=torch.float64, device="cpu") -> torch.Tensor:
    """The reference's initial guess: linear ramp vlo -> vhi along
    ``direction`` over indices 0..N-1 (``TortuosityHypreFill.F90:233-262``,
    domain_extent = N-1).  Returned as a broadcast view of the 1-D ramp."""
    n = shape[direction]
    if n > 1:
        ramp = vlo + (vhi - vlo) * torch.arange(n, dtype=dtype,
                                                device=device) / (n - 1)
    else:
        ramp = torch.full((1,), 0.5 * (vlo + vhi), dtype=dtype, device=device)
    return ramp.reshape([-1 if a == direction else 1 for a in range(3)]
                        ).expand(tuple(shape))
