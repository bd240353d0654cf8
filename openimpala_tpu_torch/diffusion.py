"""The port's CLI, the diffusion app (counterpart of
``openimpala_tpu/diffusion.py``).

Usage:  ``python -m openimpala_tpu_torch.diffusion <inputs-file> [key=value ...]``

Mirrors the reference executable (``src/props/Diffusion.cpp:171-752``):
reader dispatch by extension -> threshold to a binary phase volume ->
optional REV study -> full-domain calculation:

* ``calculation_method = homogenization`` (default): chi_x/y/z periodic cell
  problems -> D_eff tensor printed (``Diffusion.cpp:511-590``);
* ``calculation_method = flow_through``: volume fraction + TortuosityHypre
  per requested direction -> results.txt (``Diffusion.cpp:591-733``).

The console lines and ``results.txt`` are the JAX CLI's.  ``device``
(inputs key or ``device=cpu`` override; default ``cuda``) says where the
solvers run: the thresholded phase moves there once and every calculation
takes it from there.  Without a card, ``device = cuda`` raises.  On one
device and without a REV study, a TIFF stack in a layout
``TiffReader.threshold_tensor`` takes goes there as its packed pages and
is thresholded there; other files are thresholded on the host.

On the card the kernels' build and load start at reader-metadata time, in
a thread that overlaps the voxel read, the threshold and the percolation
fill (``props.tortuosity.prime_solver``, ``props.effective_diffusivity.
prime_cell_solver``; ``OPENIMPALA_NO_EARLY_WARM=1`` turns this off).
``OPENIMPALA_PROFILE=1`` prints the per-phase wall-clock table at the end
(``utils/profiling.py``).  ``OPENIMPALA_LAUNCH_COUNTS=<dir>`` makes every
rank write ``<dir>/rank<r>.json``: its kernel launches in the full-domain
calculation, and the plain forms that ran there on CUDA tensors
(``ops.stencil_cuda``), which should be none.

Several ranks (the reference's ``mpirun Diffusion inputs``)::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m openimpala_tpu_torch.diffusion <inputs-file> [key=value ...]

joins the group ``torchrun`` describes (``parallel.multihost.
initialize_from_env``: ``nccl`` where every rank has a card of its own,
``gloo`` otherwise, as on the CPU with ``device = cpu``).  Homogenisation,
and flow-through without remspot, then ingest straight into X slabs
(``load_phase_sharded``): each rank reads, or for a Z-streamed TIFF or
HDF5 file decodes its share of the pages of, the volume and keeps its
slab.  Homogenisation needs X to divide by the rank count (a periodic
cell problem cannot be padded); where it does not, every rank reads the
whole volume and ``effective_diffusivity`` falls back to one device with
a warning.  Every rank solves; only rank 0 prints the results and writes
``results.txt`` and the plotfiles, whose fields are gathered to it only
when a write happens.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import DiffusionConfig, ParmParse, resolve_solver, solver_notice
from .io.ingest import threshold_sharded
from .io.writers import read_any, write_results_txt, write_volume_hdf5_xdmf
from .ops import stencil_cuda
from .parallel import multihost
from .parallel.mesh import make_mesh
from .parallel.mesh import stats as mesh_stats
from .props.effective_diffusivity import (effective_diffusivity,
                                          prime_cell_solver)
from .props.rev import rev_study
from .props.tortuosity import prime_solver, tortuosity
from .props.volume_fraction import volume_fraction_counts
from .utils import profiling
from .utils.common import DIRECTIONS, resolve_device


def _reader(cfg: DiffusionConfig):
    path = os.path.join(cfg.data_path, cfg.filename)
    raw_dims = None
    if cfg.raw_width and cfg.raw_height and cfg.raw_depth:
        raw_dims = (cfg.raw_width, cfg.raw_height, cfg.raw_depth)
    return read_any(path, hdf5_dataset=cfg.hdf5_dataset, raw_dims=raw_dims,
                    raw_dtype=cfg.raw_datatype)


def load_phase(cfg: DiffusionConfig, reader=None) -> np.ndarray:
    # like the reference executable: threshold maps > thr -> 1, else 0; phase_id then
    # selects which binary value to analyse (Diffusion.cpp:255-261)
    reader = _reader(cfg) if reader is None else reader
    return reader.threshold(cfg.threshold_val, 1, 0)


def load_phase_sharded(cfg: DiffusionConfig, allow_pad: bool = False,
                       mesh=None, reader=None):
    """Distributed ingest (``io/ingest.py``): this rank's X slab of the
    thresholded volume, placed on the mesh's device, and the original
    shape; or None where it does not apply: no process group or one rank,
    or (``allow_pad`` False, the periodic cell problem, which cannot be
    padded) an X extent the ranks do not divide.  ``mesh``: the group's
    mesh (None: made here on ``cfg.device``)."""
    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return None
        mesh = make_mesh(device=resolve_device(cfg.device))
    if mesh.size <= 1:
        return None
    reader = _reader(cfg) if reader is None else reader
    if not allow_pad and int(reader.shape[0]) % mesh.size != 0:
        return None
    # box_size is the reference's decomposition granularity (Diffusion.cpp:
    # 209,266-268); the slabs follow the rank count, so it sets the Z chunk
    # of the streamed ingest, as in the JAX package
    return threshold_sharded(reader, cfg.threshold_val, mesh,
                             chunk=max(8, cfg.box_size))


def _gather_x(t, mesh, X: int) -> np.ndarray:
    """The whole (X, Y, Z) field on the host from this rank's X slab
    (``t``, the slab's planes of the original extent: the last ranks'
    may be shorter, or empty), for a plotfile."""
    xloc = -(-X // mesh.size)
    pad = xloc - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return mesh.all_gather_x(t.contiguous()).cpu().numpy()[:X]


def _quiet(*args, **kwargs):
    """``print`` on a rank that is not the coordinator."""


def _write_counts(path: str, rank: int):
    """``OPENIMPALA_LAUNCH_COUNTS``: this rank's kernel launches, and the
    plain forms that ran on CUDA tensors, in the full-domain calculation,
    as ``<path>/rank<rank>.json``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"rank{rank}.json"), "w") as f:
        json.dump({"launches": dict(stencil_cuda.launches),
                   "plain_on_cuda": dict(stencil_cuda.plain_on_cuda)}, f)


def parse_directions(s: str):
    s = s.upper()
    if "ALL" in s:
        return [0, 1, 2]
    return [DIRECTIONS[t] for t in s.split() if t in DIRECTIONS]


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m openimpala_tpu_torch.diffusion <inputs-file> "
              "[key=value ...]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    if os.environ.get("OPENIMPALA_PROFILE", "0") == "1":
        profiling.enable(True)

    pp = ParmParse.from_file(argv[0], overrides=argv[1:])
    cfg = DiffusionConfig.from_parmparse(pp)
    dev = resolve_device(cfg.device)
    own_group = multihost.initialize_from_env(dev)
    try:
        return _run(cfg, dev, t_start)
    finally:
        if own_group:
            dist.destroy_process_group()


@profiling.request("cli")
def _run(cfg: DiffusionConfig, dev, t_start: float) -> int:
    mesh = None
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        mesh = make_mesh(device=dev)
        dev = mesh.device
    coord = multihost.is_coordinator()  # rank 0 reports and writes
    print_ = print if coord else _quiet
    verbose = cfg.verbose if coord else 0
    os.makedirs(cfg.results_path, exist_ok=True)
    method = resolve_solver(cfg.solver_type)
    inner_dtype = None if cfg.inner_precision == "float64" else torch.float32
    if verbose >= 1:
        notice = solver_notice(cfg.solver_type)
        if notice:
            print_(f"  {notice}")
    # per-component verbosity (TortuosityHypre.cpp:150-157): an explicit
    # tortuosity.verbose overrides the global level for the tortuosity solves
    tort_verbose = (cfg.tortuosity_verbose if cfg.tortuosity_verbose >= 0
                    else cfg.verbose) if coord else 0

    if verbose >= 1:
        print_(f"Reading full domain data from: "
               f"{os.path.join(cfg.data_path, cfg.filename)}")
    # the readers are metadata-first: start the kernels' build now, so it
    # overlaps the voxel read and threshold (None off CUDA)
    warm0 = meta_reader = None
    if (not cfg.rev_do_study
            and os.environ.get("OPENIMPALA_NO_EARLY_WARM") != "1"):
        meta_reader = _reader(cfg)
        dims = (meta_reader.width, meta_reader.height, meta_reader.depth)
        if min(dims) > 0 and cfg.calculation_method == "flow_through":
            dirs = parse_directions(cfg.direction)
            if dirs:
                warm0 = prime_solver(
                    dims, dirs[0], vlo=cfg.tortuosity_vlo,
                    vhi=cfg.tortuosity_vhi, method=method,
                    precond=cfg.precond, inner_dtype=inner_dtype,
                    eps=cfg.eps, dx=cfg.voxel_size, extra_dirs=dirs[1:],
                    device=dev)
        elif min(dims) > 0 and cfg.calculation_method == "homogenization":
            warm0 = prime_cell_solver(
                dims, method=method, precond=cfg.precond,
                inner_dtype=inner_dtype, eps=cfg.eps, dx=cfg.voxel_size,
                mesh=mesh, device=dev)
    # under a group, homogenisation and flow-through without remspot ingest
    # straight into X slabs (the JAX CLI's rule)
    loaded = phase_np = None
    if mesh is not None and not cfg.rev_do_study and (
            cfg.calculation_method == "homogenization"
            or (cfg.calculation_method == "flow_through"
                and cfg.tortuosity_remspot_passes == 0)):
        sent = mesh_stats["all_to_all_bytes"]
        with profiling.phase_timer(None, "cli/read_threshold"):
            loaded = load_phase_sharded(
                cfg, allow_pad=cfg.calculation_method == "flow_through",
                mesh=mesh, reader=meta_reader)
        sent = mesh_stats["all_to_all_bytes"] - sent
    if loaded is not None:
        phase, shape = loaded  # this rank's X slab, on its device
        phase_np = None
        if verbose >= 1:
            print_(f"  Distributed ingest over {mesh.size} ranks "
                   f"({mesh.backend}): {sent} bytes of Z pages sent to the "
                   "other ranks")
    else:
        with profiling.phase_timer(None, "cli/read_threshold"):
            reader = _reader(cfg) if meta_reader is None else meta_reader
            phase = None
            if (mesh is None and not cfg.rev_do_study
                    and hasattr(reader, "threshold_tensor")):
                # a TIFF stack the run's device thresholds (None: a layout
                # it does not take)
                phase = reader.threshold_tensor(cfg.threshold_val, 1, 0, dev)
            if phase is None:
                phase_np = load_phase(cfg, reader)  # (X, Y, Z) int8, host
            elif phase.is_cuda:
                torch.cuda.synchronize(phase.device)  # the span covers it
        shape = tuple((phase if phase_np is None else phase_np).shape)
    if verbose >= 1:
        print_(f"  Domain: {shape[0]} x {shape[1]} x {shape[2]}")

    if cfg.rev_do_study:
        # every rank runs it on the whole volume (rev_study has no mesh);
        # rank 0 writes the CSV
        csv_path = os.path.join(cfg.results_path, cfg.rev_results_file)
        print_(f"\n--- Starting REV Study (Homogenization Method) for Phase "
               f"ID {cfg.phase_id} ---")
        rev_study(
            phase_np, cfg.phase_id, cfg.rev_sizes,
            num_samples=cfg.rev_num_samples,
            eps=cfg.eps, maxiter=cfg.krylov_maxiter,
            method=resolve_solver(cfg.rev_solver_type), precond=cfg.precond,
            csv_path=csv_path if coord else None,
            verbose=cfg.rev_verbose if coord else 0,
            inner_dtype=inner_dtype, dx=cfg.voxel_size,
            batch=(cfg.rev_batch if cfg.rev_batch == "auto"
                   else cfg.rev_batch in ("true", "1", "yes", "on")),
            plotfile_dir=(os.path.join(cfg.results_path, "rev_plotfiles")
                          if cfg.rev_write_plotfiles and coord else None),
            device=dev,
        )
        print_(f"REV study CSV written to: {csv_path}")

    # the full-domain calculations take the phase on their device, moved
    # once; under a group every rank passes the mesh (a slab with its
    # original shape, or the whole volume)
    if phase_np is not None:
        phase = torch.from_numpy(phase_np).to(dev)
    on_mesh = {} if mesh is None else {
        "mesh": mesh, "original_shape": shape if loaded else None}

    def _phase_host():
        """The whole phase on the host (gathered from the slabs: every
        rank calls this, rank 0 writes)."""
        if phase_np is not None:
            return phase_np
        if mesh is None:  # thresholded on the device
            return phase.cpu().numpy()
        return _gather_x(phase[:max(0, min(phase.shape[0], shape[0]
                                           - mesh.rank * phase.shape[0]))],
                         mesh, shape[0])

    counts_dir = os.environ.get("OPENIMPALA_LAUNCH_COUNTS")
    if counts_dir:
        stencil_cuda.reset_counts()
    if cfg.calculation_method == "homogenization":
        print_("\n--- Effective Diffusivity via Homogenization (Full Domain) "
               "---")
        res = effective_diffusivity(
            phase, cfg.phase_id, eps=cfg.eps, maxiter=cfg.krylov_maxiter,
            method=method, precond=cfg.precond, inner_dtype=inner_dtype,
            verbose=verbose, return_fields=cfg.write_plotfile,
            dx=cfg.voxel_size, device=dev, warm=warm0, **on_mesh,
        )
        if res.converged:
            print_("Full Domain Effective Diffusivity Tensor D_eff / "
                   "D_material:")
            for r in range(3):
                row = ", ".join(f"{res.deff[r][c]:.8e}" for c in range(3))
                print_(f"  [{row}]")
        else:
            print_("Full domain D_eff calculation skipped due to chi_k "
                   "non-convergence.")
        if cfg.write_plotfile and res.chi is not None:
            # slabs, but for the single-device fallback of an X the ranks
            # do not divide
            whole = mesh is None or res.chi[0].shape[0] == shape[0] \
                and shape[0] % mesh.size != 0
            chis = [_host(c) if whole else _gather_x(c, mesh, shape[0])
                    for c in res.chi]
            phase_h = _phase_host()
            if coord:
                base = os.path.join(cfg.results_path, "effdiff_chi")
                write_volume_hdf5_xdmf(base, {
                    "chi_x": chis[0], "chi_y": chis[1], "chi_z": chis[2],
                    "phase": phase_h.astype(np.float64),
                    # the solver's active mask (D=1 cells), matching the
                    # reference plotfile contents
                    # (EffectiveDiffusivityHypre.cpp:648-680)
                    "active_mask": (phase_h == cfg.phase_id).astype(
                        np.float64),
                })
                print(f"Field snapshot written to {base}.h5/.xmf")

    elif cfg.calculation_method == "flow_through":
        print_("\n--- Full Domain Calculation: Tortuosity via Flow-Through "
               "---")
        pc, _ = volume_fraction_counts(
            phase, cfg.phase_id, device=dev,
            mesh=mesh if loaded is not None else None)
        vf = pc / (shape[0] * shape[1] * shape[2])
        print_(f"  Volume Fraction = {vf:.8f}")
        results = {}
        for d in parse_directions(cfg.direction):
            name = "XYZ"[d]
            print_(f"\n--- Solving for Tortuosity in Direction: {name} ---")
            r = tortuosity(
                phase, cfg.phase_id, d, vlo=cfg.tortuosity_vlo,
                vhi=cfg.tortuosity_vhi, eps=cfg.eps, maxiter=cfg.krylov_maxiter,
                method=method, precond=cfg.precond,
                remspot_passes=cfg.tortuosity_remspot_passes,
                dx=cfg.voxel_size,
                inner_dtype=inner_dtype, verbose=tort_verbose,
                return_fields=cfg.write_plotfile or cfg.debug_write_active_mask,
                device=dev, warm=warm0,  # one handle for every direction
                **on_mesh,
            )
            results[f"Tortuosity_{name}"] = r.value
            print_(f"  >>> Calculated Tortuosity ({name}): {r.value:.8f} <<<")
            if cfg.write_plotfile and r.phi is not None:
                base = os.path.join(cfg.results_path,
                                    f"tortuosity_solution_{d}")
                names = ("solution_potential", "phase_id", "active_mask")
            elif cfg.debug_write_active_mask and r.active is not None:
                # debug.write_active_mask (TortuosityHypre.cpp:543-556):
                # dump just the percolation mask for inspection
                base = os.path.join(cfg.results_path, f"active_mask_{name}")
                names = ("active_mask", "phase_id")
            else:
                continue
            # under a mesh the fields are slabs, gathered for the write
            field = {"solution_potential": r.phi,
                     "active_mask": r.active.to(torch.float64)}
            fields = {k: _phase_host().astype(np.float64) if k == "phase_id"
                      else _host(field[k]) if mesh is None
                      else _gather_x(field[k], mesh, shape[0])
                      for k in names}
            if coord:
                write_volume_hdf5_xdmf(base, fields)
        out = os.path.join(cfg.results_path, cfg.output_filename)
        print_(f"\nWriting final results to: {out}")
        if coord:
            write_results_txt(out, cfg.filename, cfg.phase_id, vf, results)
    else:
        print(f"Unknown calculation_method: {cfg.calculation_method}",
              file=sys.stderr)
        return 2
    if counts_dir:
        _write_counts(counts_dir, 0 if mesh is None else mesh.rank)

    if os.environ.get("OPENIMPALA_PROFILE", "0") == "1" and coord:
        print("\nPer-phase wall-clock (OPENIMPALA_PROFILE=1):")
        profiling.report(file=sys.stdout)

    print_(f"\nTotal run time (seconds) = "
           f"{time.perf_counter() - t_start:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
