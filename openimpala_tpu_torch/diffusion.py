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
takes it from there.  Without a card, ``device = cuda`` raises.

On the card the kernels' build and load start at reader-metadata time, in
a thread that overlaps the voxel read, the threshold and the percolation
fill (``props.tortuosity.prime_solver``, ``props.effective_diffusivity.
prime_cell_solver``; ``OPENIMPALA_NO_EARLY_WARM=1`` turns this off).
``OPENIMPALA_PROFILE=1`` prints the per-phase wall-clock table at the end
(``utils/profiling.py``).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .config import DiffusionConfig, ParmParse, resolve_solver, solver_notice
from .io.writers import read_any, write_results_txt, write_volume_hdf5_xdmf
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
    os.makedirs(cfg.results_path, exist_ok=True)
    method = resolve_solver(cfg.solver_type)
    inner_dtype = None if cfg.inner_precision == "float64" else torch.float32
    if cfg.verbose >= 1:
        notice = solver_notice(cfg.solver_type)
        if notice:
            print(f"  {notice}")
    # per-component verbosity (TortuosityHypre.cpp:150-157): an explicit
    # tortuosity.verbose overrides the global level for the tortuosity solves
    tort_verbose = (cfg.tortuosity_verbose if cfg.tortuosity_verbose >= 0
                    else cfg.verbose)

    if cfg.verbose >= 1:
        print(f"Reading full domain data from: "
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
                device=dev)
    with profiling.phase_timer(None, "cli/read_threshold"):
        phase = load_phase(cfg, meta_reader)  # (X, Y, Z) int8 on the host
    shape = phase.shape
    if cfg.verbose >= 1:
        print(f"  Domain: {shape[0]} x {shape[1]} x {shape[2]}")

    if cfg.rev_do_study:
        csv_path = os.path.join(cfg.results_path, cfg.rev_results_file)
        print(f"\n--- Starting REV Study (Homogenization Method) for Phase ID "
              f"{cfg.phase_id} ---")
        rev_study(
            phase, cfg.phase_id, cfg.rev_sizes, num_samples=cfg.rev_num_samples,
            eps=cfg.eps, maxiter=cfg.krylov_maxiter,
            method=resolve_solver(cfg.rev_solver_type), precond=cfg.precond,
            csv_path=csv_path, verbose=cfg.rev_verbose, inner_dtype=inner_dtype,
            dx=cfg.voxel_size,
            batch=(cfg.rev_batch if cfg.rev_batch == "auto"
                   else cfg.rev_batch in ("true", "1", "yes", "on")),
            plotfile_dir=(os.path.join(cfg.results_path, "rev_plotfiles")
                          if cfg.rev_write_plotfiles else None),
            device=dev,
        )
        print(f"REV study CSV written to: {csv_path}")

    # the full-domain calculations take the phase on their device, moved
    # once
    phase_np = phase
    phase = torch.from_numpy(phase_np).to(dev)

    if cfg.calculation_method == "homogenization":
        print(f"\n--- Effective Diffusivity via Homogenization (Full Domain) ---")
        res = effective_diffusivity(
            phase, cfg.phase_id, eps=cfg.eps, maxiter=cfg.krylov_maxiter,
            method=method, precond=cfg.precond, inner_dtype=inner_dtype,
            verbose=cfg.verbose, return_fields=cfg.write_plotfile,
            dx=cfg.voxel_size, device=dev, warm=warm0,
        )
        if res.converged:
            print("Full Domain Effective Diffusivity Tensor D_eff / D_material:")
            for r in range(3):
                row = ", ".join(f"{res.deff[r][c]:.8e}" for c in range(3))
                print(f"  [{row}]")
        else:
            print("Full domain D_eff calculation skipped due to chi_k "
                  "non-convergence.")
        if cfg.write_plotfile and res.chi is not None:
            base = os.path.join(cfg.results_path, "effdiff_chi")
            write_volume_hdf5_xdmf(base, {
                "chi_x": _host(res.chi[0]),
                "chi_y": _host(res.chi[1]),
                "chi_z": _host(res.chi[2]),
                "phase": phase_np.astype(np.float64),
                # the solver's active mask (D=1 cells), matching the
                # reference plotfile contents
                # (EffectiveDiffusivityHypre.cpp:648-680)
                "active_mask": (phase_np == cfg.phase_id).astype(np.float64),
            })
            print(f"Field snapshot written to {base}.h5/.xmf")

    elif cfg.calculation_method == "flow_through":
        print("\n--- Full Domain Calculation: Tortuosity via Flow-Through ---")
        pc, _ = volume_fraction_counts(phase, cfg.phase_id, device=dev)
        vf = pc / (shape[0] * shape[1] * shape[2])
        print(f"  Volume Fraction = {vf:.8f}")
        results = {}
        for d in parse_directions(cfg.direction):
            name = "XYZ"[d]
            print(f"\n--- Solving for Tortuosity in Direction: {name} ---")
            r = tortuosity(
                phase, cfg.phase_id, d, vlo=cfg.tortuosity_vlo,
                vhi=cfg.tortuosity_vhi, eps=cfg.eps, maxiter=cfg.krylov_maxiter,
                method=method, precond=cfg.precond,
                remspot_passes=cfg.tortuosity_remspot_passes,
                dx=cfg.voxel_size,
                inner_dtype=inner_dtype, verbose=tort_verbose,
                return_fields=cfg.write_plotfile or cfg.debug_write_active_mask,
                device=dev, warm=warm0,  # one handle for every direction
            )
            results[f"Tortuosity_{name}"] = r.value
            print(f"  >>> Calculated Tortuosity ({name}): {r.value:.8f} <<<")
            if cfg.write_plotfile and r.phi is not None:
                base = os.path.join(cfg.results_path, f"tortuosity_solution_{d}")
                write_volume_hdf5_xdmf(base, {
                    "solution_potential": _host(r.phi),
                    "phase_id": phase_np.astype(np.float64),
                    "active_mask": _host(r.active).astype(np.float64),
                })
            elif cfg.debug_write_active_mask and r.active is not None:
                # debug.write_active_mask (TortuosityHypre.cpp:543-556):
                # dump just the percolation mask for inspection
                base = os.path.join(cfg.results_path, f"active_mask_{name}")
                write_volume_hdf5_xdmf(base, {
                    "active_mask": _host(r.active).astype(np.float64),
                    "phase_id": phase_np.astype(np.float64),
                })
        out = os.path.join(cfg.results_path, cfg.output_filename)
        print(f"\nWriting final results to: {out}")
        write_results_txt(out, cfg.filename, cfg.phase_id, vf, results)
    else:
        print(f"Unknown calculation_method: {cfg.calculation_method}",
              file=sys.stderr)
        return 2

    if os.environ.get("OPENIMPALA_PROFILE", "0") == "1":
        print("\nPer-phase wall-clock (OPENIMPALA_PROFILE=1):")
        profiling.report(file=sys.stdout)

    print(f"\nTotal run time (seconds) = {time.perf_counter() - t_start:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
