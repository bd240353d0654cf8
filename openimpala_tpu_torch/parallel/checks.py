"""Rank-side checks of the X-slab decomposition: each function takes this
rank's ``Mesh`` and host inputs of the whole volume, runs the port on the
rank's slab and returns host values (numpy arrays and Python scalars),
which the caller holds against the single-device port and the JAX
package.  Run through ``spawn.run("openimpala_tpu_torch.parallel.checks:
batch", n, args=(jobs,))``: one world for a list of jobs, so the ranks'
start-up is paid once.  This module imports only the port.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import os

import numpy as np
import torch

from ..io import RawReader, TiffReader, threshold_sharded
from ..ops import stencil_cuda
from ..ops.floodfill import percolation_mask_sharded
from ..ops.flux import deff_integrand_sum
from ..ops.masks import pad_volume_to, upload_mask
from ..ops.packfill import pack_x, percolation_oneshot_packed_sharded
from ..ops.stencil import make_cell_problem_system, make_tortuosity_system
from ..props.effective_diffusivity import effective_diffusivity
from ..props.tortuosity import tortuosity
from ..solve.refine import make_precond
from ..utils.common import any_true, count_true
from . import mesh as mesh_mod
from .halo import halo_exchange_x, slab_stencil_apply
from .mesh import shard_volume


def batch(mesh, jobs):
    """``[fn(mesh, *args) for fn, args in jobs]``, ``fn`` a name of this
    module."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def with_constants(mesh, constants, name, args):
    """``name(mesh, *args)`` (a function of this module) with module
    constants set for the call: ``constants`` maps ``"package.module:
    NAME"`` to a value, each put back afterwards.  Returns the result and
    what the call counted from zero: ``{"mesh": mesh.stats,
    "launches_at": ..., "plain_on_cuda": ...}`` (``ops/stencil_cuda``'s
    counters)."""
    saved = []
    try:
        for key, value in constants.items():
            module, attr = key.split(":")
            mod = importlib.import_module(module)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
        mesh_mod.reset_stats()
        stencil_cuda.reset_counts()
        out = globals()[name](mesh, *args)
        return out, {"mesh": dict(mesh_mod.stats),
                     "launches_at": dict(stencil_cuda.launches_at),
                     "plain_on_cuda": dict(stencil_cuda.plain_on_cuda)}
    finally:
        for mod, attr, value in reversed(saved):
            setattr(mod, attr, value)


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


# ---------------------------------------------------------------------------
# homogenisation on slabs: the periodic cell problems, their cycle and
# tensor, ``effective_diffusivity`` under the mesh, the Z-page ingest and
# the CLI
# ---------------------------------------------------------------------------


def cell_system(mesh, active, k, dx):
    """The periodic cell problem of direction ``k`` on the slab: its
    packed code, right-hand side and ``b_norm``."""
    sys_ = make_cell_problem_system(_slab(mesh, active, torch.bool), k, dx,
                                    dtype=torch.float64, mesh=mesh)
    return (sys_.code.float().cpu().numpy(), sys_.r0_b.cpu().numpy(),
            float(sys_.b_norm))


def cell_vcycle(mesh, active, r, dx, opts):
    """One application of the default cycle on the slab of the periodic
    cell problem of X, and the level it gathers at."""
    sys_ = make_cell_problem_system(_slab(mesh, active, torch.bool), 0, dx,
                                    dtype=torch.float64, mesh=mesh)
    M = make_precond(sys_, "gmg", opts)
    return M(_slab(mesh, r, torch.float64)).cpu().numpy(), M.gather


def deff_sum(mesh, active, chis, dx):
    """``deff_integrand_sum`` of the slabs of three fields."""
    slabs = [_slab(mesh, c, torch.float64) for c in chis]
    return deff_integrand_sum(*slabs, _slab(mesh, active, torch.bool), dx,
                              mesh=mesh).cpu().numpy()


def deff(mesh, phase, kw):
    """``effective_diffusivity`` of the whole volume ``phase`` (phase id 1)
    under the mesh: its tensor, iterations, rel_res, converged, lanes and
    volume fraction, the shape of this rank's chi_x, and what it wrote to
    stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        res = effective_diffusivity(phase, 1, device=mesh.device, mesh=mesh,
                                    return_fields=True, **kw)
    return {"deff": res.deff, "iterations": tuple(res.iterations),
            "rel_res": tuple(res.rel_res), "converged": res.converged,
            "lanes": res.lanes, "volume_fraction": res.volume_fraction,
            "chi_shape": tuple(res.chi[0].shape), "stderr": err.getvalue()}


def deff_slab(mesh, phase, kw):
    """``effective_diffusivity`` of this rank's slab of ``phase`` with the
    original shape, passed as a numpy array and as a tensor: the tensor,
    iterations and volume fraction of each."""
    slab = shard_volume(phase, mesh)
    out = []
    for arg in (slab, torch.from_numpy(np.ascontiguousarray(slab))):
        res = effective_diffusivity(arg, 1, device=mesh.device, mesh=mesh,
                                    original_shape=phase.shape, **kw)
        out.append({"deff": res.deff, "iterations": tuple(res.iterations),
                    "volume_fraction": res.volume_fraction})
    return out


def deff_padded_slab(mesh, phase):
    """``effective_diffusivity`` of a slab whose original X the mesh does
    not divide: the ``ValueError`` message this rank raised."""
    slab = _slab(mesh, pad_volume_to(phase, mesh.size, -1))
    try:
        effective_diffusivity(slab, 1, device=mesh.device, mesh=mesh,
                              original_shape=phase.shape)
    except ValueError as e:
        return str(e)
    return None


def zpart(mesh, path, chunk):
    """``threshold_sharded`` of a TIFF stack at 127 with the Z-page split
    and without it: both slabs, and the split's all-to-all statistics."""
    from .mesh import reset_stats, stats

    reader = TiffReader(path)
    reset_stats()
    split, shape = threshold_sharded(reader, 127.0, mesh, chunk=chunk,
                                     z_partition=True)
    comm = dict(stats)
    whole, _ = threshold_sharded(reader, 127.0, mesh, chunk=chunk,
                                 z_partition=False)
    default, _ = threshold_sharded(reader, 127.0, mesh, chunk=chunk)
    return (split.cpu().numpy(), whole.cpu().numpy(),
            default.cpu().numpy(), shape, comm)


def cli(mesh, inputs, results_root, min_cells=None):
    """The port's CLI (``diffusion.main``) on this rank with ``device =
    cpu``, a results path of the rank's own and ``OPENIMPALA_LAUNCH_COUNTS``
    set: its return code, what it printed, the ``results.txt`` it wrote
    (None where it wrote none) and its launch counts file.
    ``min_cells``: ``mesh.AUTO_SHARD_MIN_CELLS`` for the call (None: as
    it is)."""
    from unittest import mock

    from .. import diffusion
    from . import mesh as pm

    res = os.path.join(results_root, f"rank{mesh.rank}")
    counts = os.path.join(results_root, "counts")
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(out))
        stack.enter_context(mock.patch.dict(
            os.environ, {"OPENIMPALA_LAUNCH_COUNTS": counts}))
        if min_cells is not None:
            stack.enter_context(mock.patch.object(
                pm, "AUTO_SHARD_MIN_CELLS", min_cells))
        rc = diffusion.main([inputs, "device=cpu", f"results_path={res}/"])
    txt = os.path.join(res, "results.txt")
    with open(os.path.join(counts, f"rank{mesh.rank}.json")) as f:
        launched = json.load(f)
    return (rc, out.getvalue(),
            open(txt).read() if os.path.exists(txt) else None, launched)


def vf_local(mesh, phase):
    """``volume_fraction_counts`` (phase id 1) of this rank's slab of
    ``phase``, X padded to the mesh with ``PAD_FILL`` as the ingest pads:
    the rank's own pair (``local=True``) and the pair summed over the
    ranks."""
    from ..io import PAD_FILL
    from ..props.volume_fraction import volume_fraction_counts

    slab = _slab(mesh, pad_volume_to(phase, mesh.size, PAD_FILL))
    return (volume_fraction_counts(slab, 1, mesh=mesh, local=True),
            volume_fraction_counts(slab, 1, mesh=mesh))


def lanes_gate(mesh, cells):
    """The ranks sharing this rank's device, and ``use_lanes`` under the
    mesh for each global cell count of ``cells``."""
    from ..solve.lanes import use_lanes

    return (mesh.ranks_on_device(),
            [use_lanes(c, 3, "cg", mesh=mesh) for c in cells])


def vf_counts(mesh, path, shape, inputs):
    """``volume_fraction_counts`` of this rank's slab of a RAW file (uint8,
    thresholded at 127, X padded by the ingest) summed over the ranks, and
    ``diffusion.load_phase_sharded``'s answer for an inputs file (None, or
    the slab's shape and the original shape)."""
    from .. import diffusion
    from ..config import DiffusionConfig, ParmParse
    from ..props.volume_fraction import volume_fraction_counts

    slab, _ = threshold_sharded(RawReader(path, *shape, "UINT8"), 127.0,
                                mesh)
    counts = volume_fraction_counts(slab, 1, mesh=mesh)
    cfg = DiffusionConfig.from_parmparse(ParmParse.from_file(
        inputs, overrides=["device=cpu"]))
    loaded = [diffusion.load_phase_sharded(cfg, allow_pad=pad, mesh=mesh)
              for pad in (False, True)]
    return counts, [None if got is None else (tuple(got[0].shape), got[1])
                    for got in loaded]


# ---------------------------------------------------------------------------
# every preconditioner and FGMRES on slabs: the slab forms of "sa", "mg"
# and "cheby", the probed hierarchy, and the entry points above with them
# ---------------------------------------------------------------------------


def _any_system(mesh, active, kind, direction, dx):
    """The slab's flow-through system (``kind="flow"``, X padded to the
    mesh) or periodic cell problem (``"cell"``), in float64."""
    if kind == "cell":
        return make_cell_problem_system(_slab(mesh, active, torch.bool),
                                        direction, dx, dtype=torch.float64,
                                        mesh=mesh)
    return _system(mesh, active, direction, dx)


def precond_apply(mesh, active, r, kind, direction, dx, precond, opts):
    """One application of the slab form of ``precond`` (``make_precond``)
    to the slab of ``r`` (padded with zeros as the mask is): the slab of
    the result, and the level the cycle gathers at (None for a
    preconditioner without levels)."""
    M = make_precond(_any_system(mesh, active, kind, direction, dx),
                     precond, opts)
    z = M(_slab(mesh, pad_volume_to(r, mesh.size), torch.float64))
    return z.cpu().numpy(), getattr(M, "gather", None)


def sa_levels(mesh, active, r, kind, direction, dx, opts):
    """The smoothed-aggregation hierarchy of the slab system: the level it
    gathers at, each sharded level's ``(offsets, halo width, the rank's
    slab of its coefficients)``, each gathered level's ``(offsets, its
    global coefficients)``, and one application to the slab of ``r``."""
    M = make_precond(_any_system(mesh, active, kind, direction, dx), "sa",
                     opts)
    k = max(0, M.gather - 1)
    z = M(_slab(mesh, pad_volume_to(r, mesh.size), torch.float64))
    return (M.gather,
            [(l.offsets, l.width, l.packed.cpu().numpy())
             for l in M.levels[:k]],
            [(l.offsets, l.packed.cpu().numpy()) for l in M.glob.levels[k:]],
            z.cpu().numpy())
