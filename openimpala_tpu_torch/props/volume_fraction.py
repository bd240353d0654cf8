"""Volume fraction of a phase (``OpenImpala::VolumeFraction``,
``src/props/VolumeFraction.{H,cpp}``): cells equal to the phase id over the
total cell count."""

from __future__ import annotations

import numpy as np
import torch

from ..utils.common import resolve_device


def _as_tensor(phase, device):
    if isinstance(phase, torch.Tensor):
        return phase.to(device)
    return torch.from_numpy(np.ascontiguousarray(phase)).to(device)


def volume_fraction_counts(phase, phase_id: int, device=None):
    """(phase_count, total_count) — ``VolumeFraction::value(pc, tc)``
    (``VolumeFraction.cpp:22-66``), counted on ``device`` (None = CUDA)."""
    t = _as_tensor(phase, resolve_device(device))
    return int(torch.sum(t == phase_id, dtype=torch.int64)), int(t.numel())


def volume_fraction(phase, phase_id: int, device=None) -> float:
    """phase_count / total_count — ``VolumeFraction::value_vf``."""
    pc, tc = volume_fraction_counts(phase, phase_id, device)
    return pc / tc if tc > 0 else 0.0
