"""Volume fraction of a phase (``OpenImpala::VolumeFraction``,
``src/props/VolumeFraction.{H,cpp}``): cells equal to the phase id over the
total cell count."""

from __future__ import annotations

import numpy as np
import torch

from ..io.ingest import PAD_FILL
from ..utils.common import resolve_device


def _as_tensor(phase, device):
    if isinstance(phase, torch.Tensor):
        return phase.to(device)
    return torch.from_numpy(np.ascontiguousarray(phase)).to(device)


def volume_fraction_counts(phase, phase_id: int, device=None, mesh=None,
                           local: bool = False):
    """(phase_count, total_count) — ``VolumeFraction::value(pc, tc, local)``
    (``VolumeFraction.cpp:22-66``), counted on ``device`` (None = CUDA).
    Under a ``mesh``, ``phase`` is this rank's X slab (from
    ``io.ingest.threshold_sharded``), counted on the mesh's device and
    summed over the ranks: the ingest's padding (``PAD_FILL``, in no
    phase) counts in neither, so the total is the original volume's.

    ``local=True`` is the reference's skip-the-reduction mode: under a
    mesh, this rank's own pair, with no collective (the JAX package
    returns one pair per addressable shard; here a rank holds one slab,
    so its pair is its entry).  Without a mesh it changes nothing."""
    if mesh is None:
        t = _as_tensor(phase, resolve_device(device))
        return (int(torch.sum(t == phase_id, dtype=torch.int64)),
                int(t.numel()))
    t = _as_tensor(phase, mesh.device)
    counts = torch.stack([torch.sum(t == phase_id, dtype=torch.int64),
                          torch.sum(t != PAD_FILL, dtype=torch.int64)])
    if not local:
        counts = mesh.allsum(counts)
    pc, tc = counts.tolist()
    return int(pc), int(tc)


def volume_fraction(phase, phase_id: int, device=None) -> float:
    """phase_count / total_count — ``VolumeFraction::value_vf``."""
    pc, tc = volume_fraction_counts(phase, phase_id, device)
    return pc / tc if tc > 0 else 0.0
