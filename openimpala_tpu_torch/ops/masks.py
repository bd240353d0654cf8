"""Mask and field construction helpers."""

from __future__ import annotations

import numpy as np
import torch


def phase_mask(phase, phase_id: int):
    """Boolean mask of cells belonging to ``phase_id`` (reference
    ``EffectiveDiffusivityHypre.cpp:213-323``, ``Diffusion.cpp:520-530``)."""
    return phase == phase_id


def pad_volume_to(vol, multiple_x: int, fill=0):
    """Pad the X (leading) axis of a numpy volume with ``fill`` cells so
    that it divides ``multiple_x`` (the mesh size).  Inactive cells are
    identity rows of both operators, so padding changes no result; pad
    the phase with ``fill=-1`` (``io.ingest.PAD_FILL``, in no phase) or
    the percolation mask with False."""
    rem = (-vol.shape[0]) % multiple_x
    if rem == 0:
        return vol
    return np.pad(np.asarray(vol), ((0, rem), (0, 0), (0, 0)),
                  constant_values=fill)


def upload_mask(mask, mesh=None, device=None) -> torch.Tensor:
    """A boolean volume (numpy or tensor) on the device as a bool tensor:
    with a ``mesh``, only this rank's X slab, on the mesh's device, after
    X is padded with inactive cells to the mesh size (the slab that
    ``io.ingest.threshold_sharded`` would give); without one, the whole
    volume on ``device`` (None means CUDA, and raises where there is none;
    ``"cpu"`` when the caller asks for it)."""
    from ..parallel.mesh import shard_volume
    from ..utils.common import resolve_device

    m = (mask.to(torch.bool) if isinstance(mask, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(mask, bool)))
    if mesh is not None:
        rem = (-m.shape[0]) % mesh.size
        if rem:
            m = torch.cat([m, m.new_zeros((rem,) + tuple(m.shape[1:]))])
        return shard_volume(m, mesh).to(mesh.device)
    return m.to(resolve_device(device))


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
