"""Homogenised effective-diffusivity tensor (counterpart of
``openimpala_tpu/props/effective_diffusivity.py``; reference
``OpenImpala::EffectiveDiffusivityHypre``,
``src/props/EffectiveDiffusivityHypre.{H,cpp}``, plus the tensor integration
in the application, ``Diffusion.cpp:60-167``):

solve the periodic corrector (cell) problems

    div( D grad chi_k ) = -div( D e_k ),   D = 1 in the target phase else 0

for k in {X, Y, Z} with periodic BCs and internal Neumann at pore-solid
interfaces (``ops/stencil.py::make_cell_problem_system``), then
volume-average

    D_eff[a][b] = (1/N_total) * sum_active ( delta_ab - d chi_b / d xi_a ).

The operator is the same for the three directions (only the RHS carries
k), so the preconditioner is built once.  The three solves run as lockstep
lanes of one solve (``solve/lanes.py``) where they pay (``lanes_pay``: on
one card up to the measured size, on the CPU and under a mesh always) and
the memory gate ``use_lanes`` admits them, else one after the other.

Under a ``mesh`` (``parallel/mesh.py``, every rank running this driver)
each rank holds an X slab of the periodic cell problems: the X wrap
crosses from the last rank to rank 0 through the halo, the default cycle
runs on the slabs (``solve/slab_mg.py``), and the tensor's sums are
summed over the ranks (the JAX package shards the same problems along X,
``openimpala_tpu/props/effective_diffusivity.py``).  A periodic cell
problem cannot be padded (a pad plane would change the wrap coupling), so
X must divide by the mesh size: a whole volume whose X does not falls
back to one device with the JAX package's warning, and such a slab
raises.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from ..ops.floodfill import _phase_ok
from ..ops.flux import deff_integrand_sum
from ..ops.masks import upload_mask
from ..ops.stencil import make_cell_problem_system
from ..parallel.mesh import Mesh, fingerprint, require_same, resolve_mesh
from ..solve import warmup
from ..solve.cg import ResidualHistory
from ..solve.lanes import (LaneSystem, lanes_pay, solve_system_lanes,
                           use_lanes)
from ..solve.refine import make_precond, solve_system
from ..utils.common import count_true, resolve_device
from ..utils.profiling import phase_timer, request


def prime_cell_solver(shape, *, dx=(1.0, 1.0, 1.0), method: str = "cg",
                      precond: str = "auto", precond_opts: dict = None,
                      inner_dtype=torch.float32, dtype=torch.float64,
                      eps: float = 1e-9, mesh="auto", device=None):
    """Start the background build and load of the kernels a homogenisation
    solve of ``shape`` will launch, BEFORE the voxel data exists (the CLI
    calls it at reader-metadata time; ``solve/warmup.py``).  Returns a
    handle for ``effective_diffusivity(..., warm=handle)``, or None off
    CUDA (the JAX package: None off the TPU) or once the kernels are
    loaded.  ``device``: None means CUDA.  The kernels depend on
    ``precond`` alone (a solve on slabs launches the same ones); the other
    arguments, ``mesh`` among them, are the JAX package's call shape."""
    return warmup.maybe_start(precond, device=device)


@dataclasses.dataclass
class EffectiveDiffusivityResult:
    deff: np.ndarray  # (3,3) tensor, NaN if any solve failed
    converged: bool
    iterations: tuple
    rel_res: tuple
    volume_fraction: float  # active-phase VF (D=1 fraction)
    chi: tuple = None  # (chi_x, chi_y, chi_z) fields if return_fields
    # if return_history: one ResidualHistory per direction on the
    # sequential path; a 1-tuple whose entries are per-lane tuples where the
    # three solves ran as lockstep lanes
    history: tuple = None
    lanes: bool = False  # the three solves ran as lockstep lanes


@request("effective_diffusivity")
def effective_diffusivity(
    phase,
    phase_id: int,
    eps: float = 1e-9,
    maxiter: int = 20000,
    method: str = "cg",
    precond: str = "auto",
    precond_opts: dict = None,
    dx=(1.0, 1.0, 1.0),
    inner_dtype=torch.float32,
    dtype=torch.float64,
    return_fields: bool = False,
    return_history: bool = False,
    verbose: int = 0,
    lanes: bool | str = "auto",
    device=None,
    timings: dict | None = None,
    warm=None,
    mesh="auto",
    original_shape=None,
) -> EffectiveDiffusivityResult:
    """D_eff tensor of ``phase_id`` in the (X, Y, Z) volume ``phase`` (numpy
    array or tensor; a tensor's mask and count are made on its own device,
    so a phase on the card stays there) by periodic homogenisation.

    ``lanes``: ``True`` runs the three cell problems as lockstep lanes
    (``solve/lanes.py``; only with ``method`` "cg" or "pcg" and a refined
    ``inner_dtype``, else it raises), ``False`` one after the other,
    ``"auto"`` as lanes where they pay on the device (``lanes_pay``) and
    ``use_lanes`` admits them.
    ``device``: None means CUDA, and raises where there is none; pass
    ``"cpu"`` to run on the CPU.  ``timings``: optional dict that receives
    the wall seconds of each step, summed over the three directions.
    ``warm``: a handle from ``prime_cell_solver``, joined (and its failure
    raised) before the first solver kernel.

    ``mesh``: None (one rank), a ``parallel.mesh.Mesh``, or ``"auto"``
    (``tortuosity``'s rule: this process group's mesh where one is
    initialised with more than one rank and the volume has at least
    ``AUTO_SHARD_MIN_CELLS`` cells).  Under a mesh every rank calls this
    with the same arguments (checked: one gather of the shapes, the phase
    id and a CRC-32 of a whole volume; ``ValueError`` on every rank where
    they differ); the run's device is the mesh's, the result is the same
    on every rank, and ``chi`` holds the rank's X slab of each field.  A
    whole volume whose X the mesh does not divide falls back to one
    device (every rank solves it whole) with a warning on stderr.
    ``original_shape``: ``phase`` is then this rank's slab from
    ``io.ingest.threshold_sharded`` of a volume of that shape (X must
    divide by the mesh size, else ``ValueError``); with no mesh, the whole
    padded volume, which is cropped.
    """
    dev = mesh.device if isinstance(mesh, Mesh) else resolve_device(device)
    lanes_ok = method in ("cg", "pcg") and inner_dtype is not None
    if lanes is True and not lanes_ok:
        raise ValueError(
            "lanes=True needs method 'cg' or 'pcg' and an inner_dtype "
            f"(got method={method!r}, inner_dtype={inner_dtype})")
    if not isinstance(phase, torch.Tensor):
        phase = np.asarray(phase)
    if original_shape is not None:
        shape = tuple(int(v) for v in original_shape)
        # a slab from threshold_sharded is sharded whatever its size
        mesh = resolve_mesh(mesh, shape, min_cells=0, device=dev)
        if mesh is None:
            phase = phase[:shape[0]]
        elif shape[0] % mesh.size:
            raise ValueError(
                f"effective_diffusivity: X={shape[0]} not divisible by "
                f"{mesh.size} ranks; the periodic cell problem cannot be "
                "padded (crop X to a multiple of the rank count, or pass "
                "the whole volume with mesh=None)")
    else:
        shape = tuple(phase.shape)
        mesh = resolve_mesh(mesh, shape, device=dev)
        if mesh is not None and shape[0] % mesh.size:
            # always announce the fallback (the JAX package's warning)
            print(f"  WARNING: X={shape[0]} not divisible by {mesh.size} "
                  "devices; periodic cell problem cannot be padded - "
                  "falling back to single-device (crop X to a multiple of "
                  "the device count to shard)", file=sys.stderr)
            mesh = None
    slab_in = mesh is not None and original_shape is not None
    if slab_in and not isinstance(phase, torch.Tensor):
        # a host slab takes the tensor path: its mask is already this
        # rank's, and its count is summed over the ranks
        phase = torch.from_numpy(np.ascontiguousarray(phase))
    n_total = int(np.prod(shape))
    if mesh is not None:
        dev = mesh.device
        with phase_timer(timings, "mesh_check"):
            # a slab differs from rank to rank; a whole volume may not
            require_same(mesh, shape + tuple(phase.shape) + (
                phase_id, 0 if slab_in else fingerprint(phase)),
                "effective_diffusivity")
    active_np = None
    if isinstance(phase, torch.Tensor):
        # a tensor's mask is made where it lies, and a tensor on the card
        # is never copied to the host: the mask moves to ``dev`` (a no-op
        # where it is already there) and the count is one scalar read
        with phase_timer(timings, "mask_upload", dev):
            active = _phase_ok(phase, phase_id)
            if mesh is not None and not slab_in:  # this rank's slab
                n_active = count_true(active)
                active = upload_mask(active, mesh)
            else:  # the whole volume, or a slab counted over the ranks
                active = active.to(dev)
                n_active = count_true(active, mesh)
    else:
        with phase_timer(None, "host_mask"):
            active_np = phase == phase_id
            n_active = int(active_np.sum())
        active = None
    vf = n_active / n_total
    if warm is not None:  # on every path out of this call
        with phase_timer(timings, "warm_join"):
            warm.join()

    if n_active == 0:
        # zero-active shortcut: chi = 0, converged
        # (EffectiveDiffusivityHypre.cpp:558-570); under a mesh the count
        # is the ranks' sum, so every rank takes it
        chis = None
        if return_fields:
            local = shape if mesh is None else (
                shape[0] // mesh.size,) + shape[1:]
            zeros = torch.zeros(local, dtype=dtype, device=dev)
            chis = (zeros, zeros, zeros)
        return EffectiveDiffusivityResult(
            deff=np.zeros((3, 3)), converged=True, iterations=(0, 0, 0),
            rel_res=(0.0, 0.0, 0.0), volume_fraction=0.0, chi=chis,
        )

    storage = dtype if inner_dtype is None else inner_dtype
    if active is None:
        with phase_timer(timings, "mask_upload", dev):
            active = (torch.from_numpy(active_np).to(dev) if mesh is None
                      else upload_mask(active_np, mesh))
    if verbose > 0 and mesh is not None:
        print(f"  Mesh: {mesh.size} ranks ({mesh.backend}), X slabs of "
              f"{active.shape[0]}")

    ran_lanes = lanes_ok and (lanes is True or (
        lanes == "auto" and lanes_pay(n_total, dev, mesh) and use_lanes(
            n_total, 3, method, inner_bytes=_itemsize(inner_dtype),
            outer_bytes=_itemsize(dtype), device=dev, mesh=mesh)))
    if ran_lanes:
        chis, iters, rels, convs, hists = _solve_lanes(
            active, eps, maxiter, precond, precond_opts, dx, inner_dtype,
            dtype, return_history, verbose, dev, timings, mesh)
    else:
        chis, iters, rels, convs, hists = [], [], [], [], []
        M = None
        for k in range(3):
            with phase_timer(timings, "system_setup", dev):
                system = make_cell_problem_system(active, k, tuple(dx),
                                                  dtype=storage, mesh=mesh)
                # zero initial iterate (EffDiffFillMtx.F90:126)
                x0 = torch.zeros(active.shape, dtype=storage, device=dev)
            if M is None:
                # the cell-problem OPERATOR is k-independent (only the RHS
                # carries the direction), so the preconditioner builds once
                # and is shared by all three chi solves
                with phase_timer(timings, "hierarchy_build", dev):
                    M = make_precond(system, precond, precond_opts)
            hist_k = ResidualHistory() if return_history else None
            hists.append(hist_k)
            with phase_timer(timings, "solve", dev):
                chi_k, info = solve_system(
                    system, x0, eps=eps, maxiter=maxiter, method=method,
                    precond=M, inner_dtype=inner_dtype, outer_dtype=dtype,
                    precond_opts=precond_opts, verbose=verbose,
                    history=hist_k, timings=timings,
                )
            del system, x0
            chis.append(chi_k)
            iters.append(int(info.iterations))
            rels.append(float(info.rel_res))
            convs.append(bool(info.converged))
    if verbose > 0:
        for k in range(3):
            print(f"  chi_{'xyz'[k]}: iters={iters[k]} "
                  f"rel_res={rels[k]:.3e} converged={convs[k]}")

    converged = all(convs)
    if converged:
        with phase_timer(timings, "deff_tensor", dev):
            deff = deff_tensor(chis[0], chis[1], chis[2], active, dx,
                               n_total=n_total, mesh=mesh).cpu().numpy()
    else:
        deff = np.full((3, 3), math.nan)

    return EffectiveDiffusivityResult(
        deff=deff, converged=converged, iterations=tuple(iters),
        rel_res=tuple(rels), volume_fraction=vf,
        chi=tuple(chis) if return_fields else None,
        history=tuple(hists) if return_history else None,
        lanes=ran_lanes,
    )


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _solve_lanes(active, eps, maxiter, precond, precond_opts, dx,
                 inner_dtype, dtype, return_history, verbose, dev, timings,
                 mesh=None):
    """The three cell problems as lanes of one lockstep solve.  Returns
    the per-direction fields, iterations, rel_res, converged flags and the
    one history of the lockstep solve."""
    if verbose > 0:
        print("  lockstep lanes: 3 cell problems as one solve")
    with phase_timer(timings, "system_setup", dev):
        lsys = LaneSystem.from_systems([
            make_cell_problem_system(active, k, tuple(dx), dtype=inner_dtype,
                                     mesh=mesh)
            for k in range(3)])
    with phase_timer(timings, "hierarchy_build", dev):
        M = make_precond(lsys.base(), precond, precond_opts)
    hist = ResidualHistory() if return_history else None
    with phase_timer(timings, "solve", dev):
        x_full, info = solve_system_lanes(
            lsys, eps=eps, maxiter=maxiter, precond=M,
            inner_dtype=inner_dtype, outer_dtype=dtype, verbose=verbose,
            history=hist, timings=timings)
    return (tuple(x_full[k] for k in range(3)), info.iterations,
            info.rel_res, info.converged, [hist])


def deff_tensor(chi_x, chi_y, chi_z, active, dx=(1.0, 1.0, 1.0),
                n_total=None, mesh=None):
    """D_eff from solved corrector fields (``Diffusion.cpp:60-167``).

    The sum is over active cells; the divisor is the TOTAL domain cell count
    (``Diffusion.cpp:152-158``), not the active count.  Under a ``mesh``
    the fields are X slabs and ``n_total`` the global count (default: the
    slabs' cells times the ranks).
    """
    if n_total is None:
        n_total = int(np.prod(active.shape)) * (
            1 if mesh is None else mesh.size)
    return deff_integrand_sum(chi_x, chi_y, chi_z, active, dx,
                              mesh=mesh) / n_total
