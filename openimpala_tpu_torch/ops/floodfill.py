"""Percolation masking: which cells of a phase connect inlet to outlet.

The reference does a double flood fill from the inlet/outlet domain faces
and ANDs the two reachability masks (``TortuosityHypre.cpp:297-558``).  The
port runs it on the host as 6-connected component labelling
(``scipy.ndimage.label``); the native BFS binding and the bit-packed device
fill of the JAX package are not ported yet.
"""

from __future__ import annotations

import numpy as np


def _face_slices(direction: int, lo: bool):
    sl = [slice(None)] * 3
    sl[direction] = 0 if lo else -1
    return tuple(sl)


def flood_fill_host(phase_ok: np.ndarray, direction: int):
    """Host connected-components percolation: returns (reach_inlet,
    reach_outlet) boolean volumes, equivalent to the two flood fills."""
    from scipy import ndimage

    structure = ndimage.generate_binary_structure(3, 1)  # 6-connectivity
    labels, n_labels = ndimage.label(np.asarray(phase_ok, dtype=bool),
                                     structure=structure)
    reach = []
    for lo in (True, False):
        face = np.unique(labels[_face_slices(direction, lo)])
        # label -> reached lookup table: one gather instead of np.isin's sort
        lut = np.zeros(n_labels + 1, dtype=bool)
        lut[face[face > 0]] = True
        reach.append(lut[labels])
    return reach[0], reach[1]


def percolation_mask(phase, phase_id: int, direction: int,
                     method: str = "auto"):
    """Active mask = cells of ``phase_id`` reachable from BOTH the inlet and
    outlet faces of ``direction`` (``TortuosityHypre.cpp:394-558``).

    Returns ``(active: bool ndarray, active_vf: float)`` with
    ``active_vf = n_active / n_total``.  If either face carries no seed
    cells of the phase, the mask is empty and active_vf = 0
    (``TortuosityHypre.cpp:508-514``).  ``method``: "auto" or "host".
    """
    if method == "auto":
        method = "host"
    if method != "host":
        raise NotImplementedError(
            f"percolation method {method!r} is not ported; use 'host'")
    phase_np = np.asarray(phase)
    total = int(phase_np.size)
    phase_ok = phase_np == phase_id
    if (not phase_ok[_face_slices(direction, True)].any()
            or not phase_ok[_face_slices(direction, False)].any()):
        return np.zeros(phase_np.shape, bool), 0.0
    reach_in, reach_out = flood_fill_host(phase_ok, direction)
    active = reach_in & reach_out
    return active, float(active.sum()) / total
