"""Percolation masking: which cells of a phase connect inlet to outlet
(counterpart of ``openimpala_tpu/ops/floodfill.py``).

The reference does a double flood fill from the inlet/outlet domain faces
and ANDs the two reachability masks (``TortuosityHypre.cpp:297-558``).
Three methods with identical results:

* ``"host"``: 6-connected component labelling (``scipy.ndimage.label``);
* ``"native"``: the C++ BFS of ``native/impala_native.cpp`` through the
  port's own binding (``io/native.py``), inlet BFS then outlet BFS inside
  the inlet-reachable set;
* ``"device"``: the bit-packed fill of ``ops/packfill.py`` on the tensor's
  device (on the card for a CUDA run): inlet fill, then the outlet fill
  restricted to the inlet-reachable set, with one host read per round.

``flood_fill_device`` (the synchronous dilation of the reference) and
``flood_fill_device_raster`` (the int16-event raster fill) are kept for
cross-validation, as in the JAX package.

On X slabs (``parallel/mesh.py``): ``percolation_mask_sharded``, a native
BFS per slab and the exchange of the boundary planes, and the packed fill
with carries across the ranks (``packfill.
percolation_oneshot_packed_sharded``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.halo import pad_halo
from ..utils.common import resolve_device
from ..utils.profiling import phase_timer
from . import packfill

METHODS = ("host", "native", "device")


def _face_slices(direction: int, lo: bool):
    sl = [slice(None)] * 3
    sl[direction] = 0 if lo else -1
    return tuple(sl)


def flood_fill_device(phase_ok, seeds, max_iter: int | None = None):
    """Synchronous-Jacobi flood fill on the tensors' device: iterate
    ``mask |= phase_ok & dilate6(mask)`` until no change, capped at
    ``sum(dims) + 2`` like the reference (``TortuosityHypre.cpp:328``).
    ``seeds`` are ANDed with ``phase_ok``.  One host read per step.
    Returns ``(mask, steps)``."""
    phase_ok = phase_ok.to(torch.bool)
    pok = phase_ok.to(torch.int8)
    m = (seeds.to(torch.bool) & phase_ok).to(torch.int8)
    if max_iter is None:
        max_iter = int(sum(phase_ok.shape)) + 2
    it, changed = 0, True
    while changed and it < max_iter:
        mp = pad_halo(m, (False, False, False))
        nbr = (mp[:-2, 1:-1, 1:-1] | mp[2:, 1:-1, 1:-1]
               | mp[1:-1, :-2, 1:-1] | mp[1:-1, 2:, 1:-1]
               | mp[1:-1, 1:-1, :-2] | mp[1:-1, 1:-1, 2:])
        m2 = (m | nbr) & pok
        changed = not torch.equal(m2, m)
        m = m2
        it += 1
    return m.to(torch.bool), it


def _sweep_axis(reach, open_, axis: int, reverse: bool):
    """One directional raster sweep along ``axis``:
    ``reach'[i] = open[i] & (reach[i] | reach'[i-1])`` in one pass.  A cell
    is reached iff the latest event at or before it in the line is a
    "reached" event; events are one integer per cell (``2*(pos+1)+1``
    reached, ``2*(pos+1)`` blocked, 0 none), so one running maximum
    resolves the line and its parity is the answer."""
    n = reach.shape[axis]
    dt = torch.int16 if 2 * n + 1 < 32768 else torch.int32
    idx = torch.arange(n, dtype=dt, device=reach.device).reshape(
        [-1 if a == axis else 1 for a in range(3)])
    if reverse:
        idx = (n - 1) - idx
    ev = torch.where(reach, 2 * idx + 3,
                     torch.where(open_, torch.zeros((), dtype=dt,
                                                    device=reach.device),
                                 2 * idx + 2))
    if reverse:
        last = torch.cummax(ev.flip(axis), dim=axis).values.flip(axis)
    else:
        last = torch.cummax(ev, dim=axis).values
    return open_ & ((last & 1) == 1)


def flood_fill_device_raster(phase_ok, seeds, max_rounds: int | None = None):
    """Raster-scan flood fill: alternating +-X/+-Y/+-Z segmented-scan sweeps
    to the fixed point (reachability only grows, so an unchanged count is
    the fixed point), capped at ``sum(dims) + 2`` rounds.  One host read
    per round.  Returns ``(reach, rounds)``."""
    open_ = phase_ok.to(torch.bool)
    reach = seeds.to(torch.bool) & open_
    if max_rounds is None:
        max_rounds = int(sum(open_.shape)) + 2

    def one_round(reach):
        for axis in (0, 1, 2):
            for reverse in (False, True):
                reach = _sweep_axis(reach, open_, axis, reverse)
        return reach

    reach = one_round(reach)
    n_prev, n_cur, it = -1, int(reach.sum()), 1
    while n_cur != n_prev and it < max_rounds:
        reach = one_round(reach)
        n_prev, n_cur, it = n_cur, int(reach.sum()), it + 1
    return reach, it


def _percolation_device_oneshot(phase_ok, direction: int):
    """Inlet fill, then the outlet fill restricted to the inlet-reachable
    set (exact: any open path from an inlet-reachable cell to the outlet
    lies in the same component, hence in that set), on the packed words.
    Returns ``(active, n_active, rounds)``."""
    return packfill.percolation_oneshot_packed(phase_ok, direction)


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


# "auto" on a CUDA device: the device fill from this many cells up (2^23,
# between 192^3 and 224^3), the native BFS below.  Measured on an H100 at
# 700 W (scripts/torch_perc_lanes.py; PERF.md section 6), ms in X/Y/Z on
# make_blobs(n, 0.4, 0): at 128^3 native 19-21 against device 55-71, at
# 192^3 native 69-80 against 92-147, at 224^3 native 120-140 against
# 88-97 (241 on the first, cold call), at 256^3 native 174-212 against
# 112-118, at 512^3 native 2638-5268 against 250-270.  The host labelling
# is slower than the native BFS up to 256^3 and than the device fill from
# 192^3.  The device fill is launch-bound below 256^3 (about 320 small ops
# a round).
AUTO_DEVICE_MIN_CELLS = 2 ** 23


def auto_method(shape, device) -> str:
    """The method ``percolation_mask(method="auto")`` takes for a volume of
    ``shape`` wanted on ``device``: ``"host"`` on the CPU (so a CPU run
    needs no compiler), the measured rule on a CUDA device."""
    if torch.device(device).type != "cuda":
        return "host"
    if int(np.prod(shape)) >= AUTO_DEVICE_MIN_CELLS:
        return "device"
    return "native"


def _as_numpy(phase) -> np.ndarray:
    if isinstance(phase, torch.Tensor):
        return phase.cpu().numpy()
    return np.asarray(phase)


def upload_phase(phase, device) -> torch.Tensor:
    """A phase volume on ``device`` as it is (no comparison, no packing on
    the host): a tensor moves as it is, a numpy array goes up as uint8
    where its values fit, else in its own dtype."""
    if isinstance(phase, torch.Tensor):
        return phase.to(device)
    phase = np.ascontiguousarray(phase)
    if phase.dtype != np.uint8 and phase.dtype.kind in "iub" and (
            phase.size == 0 or (phase.min() >= 0 and phase.max() <= 255)):
        phase = phase.astype(np.uint8)
    return torch.from_numpy(phase).to(device)


def _phase_ok(phase_t: torch.Tensor, phase_id: int) -> torch.Tensor:
    """``phase == phase_id`` on the tensor's device; an id that a uint8
    volume cannot hold matches nothing."""
    if phase_t.dtype == torch.uint8 and not 0 <= phase_id <= 255:
        return torch.zeros(phase_t.shape, dtype=torch.bool,
                           device=phase_t.device)
    return phase_t == phase_id


def percolation_mask(phase, phase_id: int, direction: int,
                     method: str = "auto", device=None):
    """Active mask = cells of ``phase_id`` reachable from BOTH the inlet and
    outlet faces of ``direction`` (``TortuosityHypre.cpp:394-558``).

    Returns ``(active, active_vf)`` with ``active_vf = n_active /
    n_total``.  If either face carries no seed cells of the phase, the mask
    is empty and active_vf = 0 (``TortuosityHypre.cpp:508-514``).

    ``phase``: a numpy array or a tensor.  ``device``: where the mask is
    wanted; None means the tensor's device, or the host for a numpy array.
    ``method``: ``"host"`` and ``"native"`` return a bool numpy array,
    ``"device"`` a bool tensor on ``device`` (a numpy phase is uploaded as
    it is and compared there); ``"auto"`` is ``auto_method``'s choice.  A
    method that cannot run raises; none falls back to another.
    """
    if device is None:
        device = phase.device if isinstance(phase, torch.Tensor) else "cpu"
    device = resolve_device(device)
    if method == "auto":
        method = auto_method(phase.shape, device)
    if method not in METHODS:
        raise ValueError(f"unknown percolation method {method!r}; "
                         f"expected 'auto' or one of {METHODS}")
    total = int(np.prod(phase.shape))

    if method == "device":
        with phase_timer(None, "fill_device"):
            phase_ok = _phase_ok(upload_phase(phase, device), phase_id)
            # empty seed faces need no early-out: they give an empty mask
            active, n_active, _ = _percolation_device_oneshot(phase_ok,
                                                              direction)
            return active, int(n_active) / total

    with phase_timer(None, "label_host"):  # the host's copy included
        phase_np = _as_numpy(phase)
        if method == "native":
            from ..io import native

            res = native.percolation_mask_phase(phase_np, phase_id,
                                                direction)
            if res is None:  # dtype outside the fused compare
                res = native.percolation_mask(phase_np == phase_id,
                                              direction)
            active, n_active = res
            return active, n_active / total

        phase_ok = phase_np == phase_id
        if (not phase_ok[_face_slices(direction, True)].any()
                or not phase_ok[_face_slices(direction, False)].any()):
            return np.zeros(phase_np.shape, bool), 0.0
        reach_in, reach_out = flood_fill_host(phase_ok, direction)
        active = reach_in & reach_out
        return active, float(active.sum()) / total


def percolation_mask_sharded(phase, phase_id: int, direction: int, mesh,
                             original_shape=None):
    """Percolation of this rank's X slab ``phase`` (numpy or tensor; ingest
    padding holds ``io.ingest.PAD_FILL``, in no phase) of a volume
    decomposed over ``mesh``: a native seeded BFS on every slab, then an
    exchange of the boundary planes, repeated until the sum over the ranks
    of the cells newly seeded across a seam is 0 (the JAX package's
    ``percolation_mask_sharded``; reference parallelFloodFill,
    ``TortuosityHypre.cpp:297-389``): each BFS is linear in its slab, and
    the rounds are the crossings of the pore network between slabs,
    typically 2 to 4.  The seeds sit on the original faces
    (``original_shape``; default the padded global shape).

    Returns ``(active, active_vf)``: the slab's bool numpy mask and the
    global active volume fraction (the same on every rank).  Raises where
    the native library is unavailable."""
    from ..io import native

    native.require_lib()
    ok = np.ascontiguousarray(_as_numpy(phase) == phase_id).astype(np.int8)
    xl = ok.shape[0]
    x0 = mesh.rank * xl
    shape = (tuple(original_shape) if original_shape
             else (xl * mesh.size,) + ok.shape[1:])

    def fill(face: int):
        mask = np.zeros_like(ok)
        seeds = np.zeros_like(ok)
        if direction != 0:
            seeds[_plane_index(direction, face)] = 1
        elif x0 <= face < x0 + xl:
            seeds[face - x0] = 1
        while True:
            if seeds.any():
                out, _ = native.bfs_seeded(ok, mask, seeds)
                mask = out.view(np.int8)
            # the planes reached at the slab's faces seed the neighbours
            lo, hi = (t.cpu().numpy() for t in mesh.exchange(
                _on(mesh, mask[0]), _on(mesh, mask[-1]), False))
            seeds = np.zeros_like(ok)
            seeds[0] = lo & ok[0] & ~mask[0]
            seeds[-1] |= hi & ok[-1] & ~mask[-1]
            if int(mesh.allsum(_on(mesh, np.int64(seeds.sum())))) == 0:
                return mask.view(bool)

    active = fill(0) & fill(shape[direction] - 1)
    n_active = int(mesh.allsum(_on(mesh, np.int64(active.sum()))))
    return active, n_active / float(np.prod(shape))


def _on(mesh, a):
    """A host value as a tensor on the mesh's device (what its backend
    sends)."""
    return torch.from_numpy(np.array(a)).to(mesh.device)


def _plane_index(direction: int, index: int):
    sl = [slice(None)] * 3
    sl[direction] = index
    return tuple(sl)
