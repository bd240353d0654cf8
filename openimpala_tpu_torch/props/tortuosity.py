"""Flow-through tortuosity driver (counterpart of
``openimpala_tpu/props/tortuosity.py``; reference
``OpenImpala::TortuosityHypre``, ``src/props/TortuosityHypre.{H,cpp}``):

1. optional remspot filter (``TortuosityHypre.cpp:248-292``);
2. percolation mask from inlet/outlet faces (``:394-558``): the
   bit-packed fill on the card, the native BFS or the host labelling
   (``ops/floodfill.py``); active VF = n_active / n_total;
3. free-set system with the packed bf16 geometry, float32 PCG inside
   float64 iterative refinement, preconditioned by the Galerkin multigrid
   V-cycle (the stencil kernels K1 and K2 on the card) or, with
   ``precond="sa"``, by the smoothed-aggregation cycle (K1 and K3);
4. boundary fluxes, the conservation gate rel_diff <= 1e-6 (``:794-823``),
   and tau = active_vf / Deff with the reference's NaN/Inf policy
   (``:831-877``).

Under a ``mesh`` (``parallel/mesh.py``, every rank running this driver)
each rank holds an X slab: the volume is padded in X to the mesh size
with inactive cells (the outlet of X stays at the original face), the
percolation runs on the whole volume on every rank or, for a slab from
``io.ingest.threshold_sharded``, on the slabs (the packed fill with
carries across the ranks, else the native BFS with plane exchanges), and
the solve, the fluxes and tau run on the slabs (the reference's box
decomposition, ``Diffusion.cpp:266-268``, ``TortuosityHypre.cpp:584-585``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.filters import remspot
from ..ops.floodfill import (
    _phase_ok,
    auto_method,
    percolation_mask,
    percolation_mask_sharded,
    upload_phase,
)
from ..ops.flux import boundary_fluxes
from ..ops.masks import linear_ramp, upload_mask
from ..ops.packfill import percolation_oneshot_packed_sharded
from ..ops.stencil import make_tortuosity_system
from ..parallel.mesh import (
    Mesh,
    fingerprint,
    require_same,
    resolve_mesh,
    slab_range,
)
from ..solve import warmup
from ..solve.cg import ResidualHistory
from ..solve.refine import solve_system
from ..utils.common import parse_direction, resolve_device
from ..utils.profiling import phase_timer, request

TINY_FLUX = 1e-15  # reference tiny_flux_threshold, TortuosityHypre.cpp:64
FLUX_TOL = 1e-6  # reference flux conservation gate, TortuosityHypre.cpp:794


def _build_system(active, direction, vlo, vhi, dx, storage, hi_plane=None,
                  mesh=None, x_extent=None):
    """System + initial guess (the linear ramp on free cells).  Under a
    ``mesh``, this rank's slab of them; the ramp of X runs over the padded
    global extent, as the JAX package's sharded driver's does.
    ``x_extent``: the volume's X extent before the mesh's padding."""
    sys_ = make_tortuosity_system(active, direction, vlo, vhi, dx,
                                  dtype=storage, hi_plane=hi_plane,
                                  mesh=mesh, x_extent=x_extent)
    shape = tuple(active.shape)
    if mesh is not None and direction == 0:
        x0 = mesh.rank * shape[0]
        ramp = linear_ramp((shape[0] * mesh.size,) + shape[1:], 0, vlo, vhi,
                           dtype=storage, device=active.device
                           )[x0:x0 + shape[0]]
    else:
        ramp = linear_ramp(shape, direction, vlo, vhi, dtype=storage,
                           device=active.device)
    x0 = torch.where(sys_.free, ramp,
                     torch.zeros((), dtype=storage, device=active.device))
    return sys_, x0


@dataclasses.dataclass
class TortuosityResult:
    value: float  # tau (NaN / Inf per reference edge cases)
    deff: float
    active_vf: float
    flux_in: float
    flux_out: float
    flux_rel_diff: float
    flux_conserved: bool
    iterations: int
    rel_res: float
    converged: bool
    direction: int
    phi: object = None  # potential field (if return_fields)
    # percolation mask (if return_fields): a bool tensor on the run's device
    active: object = None
    history: object = None  # ResidualHistory (if return_history)
    percolation_method: str = None  # the method that made the mask


def prime_solver(shape, direction, *, vlo: float = -1.0, vhi: float = 1.0,
                 dx=(1.0, 1.0, 1.0), method: str = "cg",
                 precond: str = "auto", precond_opts: dict = None,
                 inner_dtype=torch.float32, dtype=torch.float64,
                 eps: float = 1e-9, mesh="auto",
                 percolation_method: str = "auto", extra_dirs=(),
                 device=None):
    """Start the background build and load of the kernels a flow-through
    solve of ``shape`` along ``direction`` will launch, BEFORE the voxel
    data exists: the CLI calls it at reader-metadata time, so the build
    overlaps the file read, the threshold and the percolation fill
    (``solve/warmup.py``).  Returns a handle to pass as ``tortuosity(...,
    warm=handle)`` (the same handle to every direction of ``extra_dirs``),
    or None where warming cannot pay: off CUDA, as the JAX package returns
    None off the TPU, or once the kernels are loaded.  ``device``: None
    means CUDA.  The kernels depend on ``precond`` alone (a solve on slabs
    launches the same ones); the other arguments, ``mesh`` among them, are
    the JAX package's call shape."""
    return warmup.maybe_start(precond, device=device)


@request("tortuosity")
def tortuosity(
    phase,
    phase_id: int,
    direction,
    vlo: float = -1.0,
    vhi: float = 1.0,
    eps: float = 1e-9,
    maxiter: int = 20000,
    method: str = "cg",
    precond: str = "auto",
    precond_opts: dict = None,
    dx=(1.0, 1.0, 1.0),
    remspot_passes: int = 0,
    percolation_method: str = "auto",
    inner_dtype=torch.float32,
    dtype=torch.float64,
    return_fields: bool = False,
    return_history: bool = False,
    verbose: int = 0,
    device=None,
    timings: dict | None = None,
    warm=None,
    mesh="auto",
    original_shape=None,
) -> TortuosityResult:
    """Flow-through tortuosity of ``phase_id`` along ``direction`` of the
    (X, Y, Z) volume ``phase`` (numpy array or tensor).

    ``percolation_method``: ``"auto"`` (``ops.floodfill.auto_method``:
    the host labelling on the CPU, the rule measured on the card for
    CUDA), ``"host"``, ``"native"`` or ``"device"`` (the bit-packed fill on
    the run's device; a numpy ``phase`` is uploaded as it is, a tensor
    stays where it is).  ``device``: None means CUDA, and raises where
    there is none; pass ``"cpu"`` to run on the CPU.  ``timings``: optional
    dict that receives the wall seconds of each step (the device is
    synchronised at each step's end, so the times include the queued
    device work).  ``warm``: a handle from ``prime_solver``; without one,
    on CUDA the kernels' build starts here in a thread that overlaps the
    percolation fill (``solve/warmup.py``); either way it is joined, and
    its failure raised, before the solve's first kernel.

    ``mesh``: None (one rank), a ``parallel.mesh.Mesh``, or ``"auto"``
    (this process group's mesh where one is initialised with more than one
    rank and the volume has at least ``AUTO_SHARD_MIN_CELLS`` cells; with
    no group, None).  Under a mesh every rank calls this with the same
    arguments: one gather of the shapes, the phase id, the direction and a
    CRC-32 of the volume checks it and raises ``ValueError`` on every rank
    where they differ (so a job whose ranks each solve a volume of their
    own, or where one rank alone calls this, passes ``mesh=None``).  The
    run's device is the mesh's (``device`` is then not read), and the
    result is the same on every rank but for ``phi`` and ``active``,
    which are the rank's X slab (cropped to the original extent).
    ``original_shape``: ``phase``
    is then this rank's slab from ``io.ingest.threshold_sharded`` (X
    padded with ``PAD_FILL``) of a volume of that shape; with no mesh, the
    whole padded volume, which is cropped.
    """
    # a Mesh names its rank's device
    dev = mesh.device if isinstance(mesh, Mesh) else resolve_device(device)
    direction = parse_direction(direction)
    if not isinstance(phase, torch.Tensor):
        phase = np.asarray(phase)
    if original_shape is not None:
        shape = tuple(int(v) for v in original_shape)
        # a slab from threshold_sharded is sharded whatever its size
        mesh = resolve_mesh(mesh, shape, min_cells=0, device=dev)
        if mesh is None:
            phase = phase[:shape[0]]
    else:
        shape = tuple(phase.shape)
        mesh = resolve_mesh(mesh, shape, device=dev)
    slab_in = mesh is not None and original_shape is not None
    hi_plane = None
    if mesh is not None:
        with phase_timer(timings, "mesh_check"):
            # a slab differs from rank to rank; a whole volume may not
            require_same(mesh, shape + tuple(phase.shape) + (
                phase_id, direction, 0 if slab_in else fingerprint(phase)),
                "tortuosity")
        dev = mesh.device
        if (-shape[0]) % mesh.size and direction == 0:
            hi_plane = shape[0] - 1  # the outlet stays at the original face
    perc = percolation_method
    if perc == "auto" and not slab_in:
        perc = auto_method(shape, dev)

    if remspot_passes > 0:
        if slab_in:
            raise NotImplementedError(
                "remspot filtering of a slab is not supported; filter the "
                "volume before ingest")
        with phase_timer(timings, "remspot"):
            if isinstance(phase, torch.Tensor):
                phase = remspot(phase, remspot_passes)
            else:
                phase = remspot(torch.from_numpy(np.ascontiguousarray(
                    phase)), remspot_passes).numpy()

    if warm is None:
        # no early handle from prime_solver: start the build now so that
        # it overlaps the percolation fill
        warm = warmup.maybe_start(precond, device=dev)
    if slab_in:
        with phase_timer(timings, "percolation_mask", dev):
            active, active_vf, perc = _percolation_slab(
                phase, phase_id, direction, shape, mesh)
    else:
        if perc == "device":  # the mask is made, and stays, on the card
            with phase_timer(timings, "phase_upload", dev):
                phase = upload_phase(phase, dev)
        # under a mesh the whole volume's mask on every rank (the JAX
        # package's host path), of which each keeps its slab below
        with phase_timer(timings, "percolation_mask", dev):
            active, active_vf = percolation_mask(phase, phase_id, direction,
                                                 method=perc, device=dev)
    del phase
    if warm is not None:
        # before any solver kernel, and on every path out of this call:
        # the thread's launches never overlap a capture
        with phase_timer(timings, "warm_join"):
            warm.join()

    nanres = TortuosityResult(
        value=math.nan, deff=math.nan, active_vf=active_vf,
        flux_in=0.0, flux_out=0.0, flux_rel_diff=math.nan,
        flux_conserved=False, iterations=0, rel_res=math.nan,
        converged=False, direction=direction, percolation_method=perc,
    )
    if active_vf <= np.finfo(np.float64).eps:
        # zero percolation: NaN, matching TortuosityHypre.cpp:170-178,764-777
        return nanres

    if mesh is not None and not slab_in:  # this rank's slab, X padded
        with phase_timer(timings, "mask_upload", dev):
            active_t = upload_mask(active, mesh)
    elif isinstance(active, torch.Tensor):
        active_t = active
    else:  # a host or native mask
        with phase_timer(timings, "mask_upload", dev):
            active_t = torch.from_numpy(active).to(dev)
    del active
    if verbose > 0 and mesh is not None:
        print(f"  Mesh: {mesh.size} ranks ({mesh.backend}), X {shape[0]}->"
              f"{active_t.shape[0] * mesh.size}")
    storage = dtype if inner_dtype is None else inner_dtype
    with phase_timer(timings, "system_setup", dev):
        system, x0_free = _build_system(active_t, direction, float(vlo),
                                        float(vhi), tuple(dx), storage,
                                        hi_plane, mesh, shape[0])

    hist = ResidualHistory() if return_history else None
    with phase_timer(timings, "solve", dev):
        x_full, info = solve_system(
            system, x0_free, eps=eps, maxiter=maxiter, method=method,
            precond=precond, inner_dtype=inner_dtype, outer_dtype=dtype,
            precond_opts=precond_opts, verbose=verbose, history=hist,
            timings=timings,
        )
    del system, x0_free
    if mesh is not None and return_fields:  # the slab's original planes
        x0, _ = slab_range(mesh, shape[0])
        keep = max(0, min(active_t.shape[0], shape[0] - x0))
        x_full, active_t = x_full[:keep], active_t[:keep]
    iterations = int(info.iterations)
    rel_res = float(info.rel_res)
    converged = bool(info.converged)
    if verbose > 0:
        print(f"  Solver iterations: {iterations}  rel_res: {rel_res:.3e}  "
              f"converged: {converged}")
    if not converged:
        return dataclasses.replace(
            nanres, iterations=iterations, rel_res=rel_res,
            phi=x_full if return_fields else None,
            active=active_t if return_fields else None,
            history=hist,
        )

    with phase_timer(timings, "flux", dev):
        flux_in, flux_out = boundary_fluxes(x_full, active_t, direction, dx,
                                            mesh=mesh, extent=shape[0])
        flux_in, flux_out = float(flux_in), float(flux_out)
    return _result(shape, direction, dx, vlo, vhi, active_vf, flux_in,
                   flux_out, verbose, iterations=iterations, rel_res=rel_res,
                   converged=converged,
                   phi=x_full if return_fields else None,
                   active=active_t if return_fields else None,
                   history=hist, percolation_method=perc)


def _percolation_slab(phase, phase_id, direction, shape, mesh):
    """The percolation of a slab from ``io.ingest.threshold_sharded``: the
    packed fill with carries across the ranks where X divides 32 times the
    ranks, else the native BFS per slab with plane exchanges.  Returns
    ``(active, active_vf, method)``."""
    outlet = shape[direction] - 1  # the original face, not the padding
    phase_ok = _phase_ok(upload_phase(phase, mesh.device), phase_id)
    res = percolation_oneshot_packed_sharded(phase_ok, direction, mesh,
                                             outlet=outlet)
    del phase_ok
    if res is not None:
        active, counts, _ = res
        n_active = int(mesh.allsum(counts.sum()))
        return active, n_active / float(np.prod(shape)), "device"
    active, active_vf = percolation_mask_sharded(
        phase, phase_id, direction, mesh, original_shape=shape)
    return active, active_vf, "native"


def _result(shape, direction, dx, vlo, vhi, active_vf, flux_in, flux_out,
            verbose, **fields) -> TortuosityResult:
    """The conservation gate and tau from the two face fluxes."""
    mag_in, mag_out = abs(flux_in), abs(flux_out)
    mag_avg = 0.5 * (mag_in + mag_out)
    if mag_avg > TINY_FLUX:
        rel_diff = abs(mag_in - mag_out) / mag_avg
        flux_conserved = rel_diff <= FLUX_TOL
    else:
        rel_diff, flux_conserved = 0.0, True
    if verbose > 0:
        print(f"  Flux in/out: {flux_in:.8f} / {flux_out:.8f}  "
              f"rel_diff: {rel_diff:.3e}  conserved: {flux_conserved}")

    # geometry: RealBox is [0, N_d * dx_d] per axis (Diffusion.cpp:302-305)
    L = shape[direction] * float(dx[direction])
    others = [a for a in range(3) if a != direction]
    A = (shape[others[0]] * float(dx[others[0]])) * (
        shape[others[1]] * float(dx[others[1]]))
    grad_phi = (vhi - vlo) / L

    # tau computation + edge cases (TortuosityHypre.cpp:843-877)
    if not flux_conserved:
        value, deff = math.nan, math.nan
    elif mag_avg < TINY_FLUX:
        value, deff = math.inf, 0.0
    elif abs(grad_phi) < TINY_FLUX:
        value, deff = math.inf, 0.0
    else:
        deff = (mag_avg / A) / abs(grad_phi)
        value = math.inf if abs(deff) < TINY_FLUX else active_vf / deff

    return TortuosityResult(
        value=value, deff=deff, active_vf=active_vf,
        flux_in=flux_in, flux_out=flux_out, flux_rel_diff=rel_diff,
        flux_conserved=flux_conserved, direction=direction, **fields)
