"""Rank-side checks of the X-slab decomposition: each function takes this
rank's ``Mesh`` and host inputs of the whole volume, runs the port on the
rank's slab and returns host values (numpy arrays and Python scalars),
which the caller holds against the single-device port and the JAX
package.  Run through ``spawn.run("openimpala_tpu_torch.parallel.checks:
batch", n, args=(jobs,))``: one world for a list of jobs, so the ranks'
start-up is paid once.  This module imports only the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import RawReader, TiffReader, threshold_sharded
from ..ops.floodfill import percolation_mask_sharded
from ..ops.masks import pad_volume_to, upload_mask
from ..ops.packfill import pack_x, percolation_oneshot_packed_sharded
from ..ops.stencil import make_tortuosity_system
from ..props.tortuosity import tortuosity
from ..solve.refine import make_precond
from ..utils.common import any_true, count_true
from .halo import halo_exchange_x, slab_stencil_apply
from .mesh import shard_volume


def batch(mesh, jobs):
    """``[fn(mesh, *args) for fn, args in jobs]``, ``fn`` a name of this
    module."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def _slab(mesh, a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(shard_volume(a, mesh)))
    return t.to(mesh.device, dtype)


def _neighbour_sum(xp):
    return (xp[:-2, 1:-1, 1:-1] + xp[2:, 1:-1, 1:-1]
            + xp[1:-1, :-2, 1:-1] + xp[1:-1, 2:, 1:-1]
            + xp[1:-1, 1:-1, :-2] + xp[1:-1, 1:-1, 2:])


def halo(mesh, x, periodic_x: bool):
    """``halo_exchange_x`` of the slab, and the six-neighbour sum through
    ``slab_stencil_apply`` (X wrapped or clamped, Y and Z clamped)."""
    s = _slab(mesh, x)
    op = slab_stencil_apply(_neighbour_sum, mesh, (periodic_x, False, False))
    return (halo_exchange_x(s, periodic_x, mesh).cpu().numpy(),
            op(s).cpu().numpy())


def _system(mesh, active, direction, dx, dtype=torch.float64):
    """The flow-through system of the slab, X padded with inactive cells
    to the mesh (``x_extent``: the mask's own X)."""
    return make_tortuosity_system(upload_mask(active, mesh), direction,
                                  -1.0, 1.0, dx, dtype=dtype, mesh=mesh,
                                  x_extent=active.shape[0])


def matvec(mesh, active, x, direction, dx):
    """The flow-through operator on the slab, ``(A x, <x, A x>)``, and the
    slab's packed code and ``b_norm``."""
    sys_ = _system(mesh, active, direction, dx)
    out, dot = sys_.apply_with_dot(_slab(mesh, x, torch.float64))
    return (out.cpu().numpy(), float(dot),
            sys_.code.float().cpu().numpy(), float(sys_.b_norm))


def vcycle(mesh, active, r, direction, dx, opts):
    """One application of the default Galerkin cycle on the slab (the
    preconditioner ``make_precond`` builds for a slab system; ``r``
    padded with zeros as the mask is), and the level it gathers at."""
    sys_ = _system(mesh, active, direction, dx)
    M = make_precond(sys_, "gmg", opts)
    z = M(_slab(mesh, pad_volume_to(r, mesh.size), torch.float64))
    return z.cpu().numpy(), M.gather


def _scalars(res) -> dict:
    return {k: getattr(res, k) for k in (
        "value", "deff", "active_vf", "flux_in", "flux_out",
        "flux_rel_diff", "flux_conserved", "iterations", "rel_res",
        "converged", "percolation_method")}


def tau(mesh, phase, direction, kw):
    """``tortuosity`` of the whole volume ``phase`` (phase id 1) under the
    mesh: its scalars, the same on every rank."""
    res = tortuosity(phase, 1, direction, device=mesh.device, mesh=mesh,
                     **kw)
    return _scalars(res)


def tau_mismatch(mesh, phase, direction):
    """``tortuosity`` under the mesh where rank 1's volume differs from
    the others' in one cell: the message of the ``ValueError`` this rank
    raised (None where it raised none)."""
    phase = phase.copy()
    if mesh.rank == 1:
        phase[0, 0, 0] = 1 - phase[0, 0, 0]
    try:
        tortuosity(phase, 1, direction, device=mesh.device, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def ingest(mesh, path, kind, shape, direction, kw):
    """``threshold_sharded`` of a RAW (``kind="raw"``, uint8, ``shape``)
    or TIFF file at 127, then ``tortuosity`` of the slab with its
    ``original_shape``: the slab and the result's scalars."""
    reader = (RawReader(path, *shape, "UINT8") if kind == "raw"
              else TiffReader(path))
    slab, orig = threshold_sharded(reader, 127.0, mesh, chunk=5)
    res = tortuosity(slab, 1, direction, device=mesh.device, mesh=mesh,
                     original_shape=orig, **kw)
    return slab.cpu().numpy(), orig, _scalars(res)


def percolation(mesh, phase, direction, original_shape=None):
    """Both sharded fills of the slab of ``phase`` (phase id 1): the packed
    fill's words and per-word-plane counts (None where it refuses the
    layout), the native BFS's mask and active VF, and ``count_true`` and
    ``any_true`` of that mask over the ranks."""
    slab = _slab(mesh, phase)
    shape = tuple(original_shape or phase.shape)
    res = percolation_oneshot_packed_sharded(
        slab == 1, direction, mesh, outlet=shape[direction] - 1)
    packed = None if res is None else (pack_x(res[0]).cpu().numpy(),
                                       res[1].cpu().numpy())
    active, vf = percolation_mask_sharded(slab.cpu().numpy(), 1, direction,
                                          mesh, original_shape=shape)
    t = torch.from_numpy(active)
    return packed, active, vf, (count_true(t, mesh), any_true(t, mesh))
