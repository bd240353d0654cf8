"""Phase-field pre-filters."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def remspot(phase: torch.Tensor, n_passes: int = 1) -> torch.Tensor:
    """Isolated-voxel removal filter (``tortuosity_remspot``,
    ``Tortuosity_filcc.F90:88-177``; driver ``TortuosityHypre.cpp:248-292``).

    A voxel none of whose 6 neighbours shares its phase is flipped
    (0 <-> 1).  Out-of-domain neighbours never match.  Simultaneous
    (Jacobi) update, as in the JAX package.
    """
    p = phase
    for _ in range(int(n_passes)):
        # int64 ghost layer of -1: no phase id equals it
        pp = F.pad(p.to(torch.int64), (1, 1, 1, 1, 1, 1), value=-1)
        q = p.to(torch.int64)
        connected = (
            (pp[:-2, 1:-1, 1:-1] == q) | (pp[2:, 1:-1, 1:-1] == q)
            | (pp[1:-1, :-2, 1:-1] == q) | (pp[1:-1, 2:, 1:-1] == q)
            | (pp[1:-1, 1:-1, :-2] == q) | (pp[1:-1, 1:-1, 2:] == q)
        )
        flipped = torch.where(p == 0, torch.ones_like(p), torch.zeros_like(p))
        p = torch.where(connected, p, flipped)
    return p
