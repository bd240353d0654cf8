"""REV (representative elementary volume) study (counterpart of
``openimpala_tpu/props/rev.py``).

Re-design of the REV loop in ``src/props/Diffusion.cpp:317-504``: for each of
``num_samples`` random sub-volume origins x each target size, crop the phase
volume, solve the three periodic cell problems on the crop, integrate the
D_eff tensor, and append a CSV row

    SampleNo,SeedX,SeedY,SeedZ,REV_Size_Target,ActualSizeX,ActualSizeY,
    ActualSizeZ,D_xx,D_yy,D_zz,D_xy,D_xz,D_yz

(``Diffusion.cpp:338,485-499``).  Crops whose clipped box has longest side
< 8 are skipped (``Diffusion.cpp:361``).  RNG: the reference seeds
``std::mt19937(rank + 12345 + num_samples)``; both packages use
``numpy.random.default_rng(12345 + num_samples)``, so they draw the same
boxes.

Same-size crops are independent; ``batch=True`` stacks them and runs the
three direction solves per crop as lanes of one batched PCG
(``solve/batched.py``).  The default ``batch="auto"`` decides PER
SAME-SHAPE GROUP: lockstep lanes pay while a single crop underfills the
card; a large crop goes to the sequential multigrid solver
(``auto_batch_max_cells``: measured on the card, the JAX package's value
on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..utils.common import resolve_device
from ..utils.profiling import phase_timer, request
from .effective_diffusivity import effective_diffusivity


@dataclasses.dataclass
class RevSample:
    sample_no: int
    seed: tuple
    size_target: int
    actual_size: tuple
    deff: np.ndarray  # (3,3)
    converged: bool


CSV_HEADER = (
    "SampleNo,SeedX,SeedY,SeedZ,REV_Size_Target,ActualSizeX,ActualSizeY,"
    "ActualSizeZ,D_xx,D_yy,D_zz,D_xy,D_xz,D_yz"
)


def csv_row(s: RevSample) -> str:
    d = s.deff
    vals = [d[0, 0], d[1, 1], d[2, 2], d[0, 1], d[0, 2], d[1, 2]]
    return (
        f"{s.sample_no},{s.seed[0]},{s.seed[1]},{s.seed[2]},{s.size_target},"
        f"{s.actual_size[0]},{s.actual_size[1]},{s.actual_size[2]},"
        + ",".join(f"{v:.8f}" for v in vals)
    )


def _draw_samples(phase, sizes, num_samples, rng, verbose):
    """Random crop boxes: origin per axis uniform in [0, N-size]
    (Diffusion.cpp:344-357), clipped, longside >= 8 (Diffusion.cpp:361)."""
    shape = phase.shape
    boxes = []
    for s_idx in range(int(num_samples)):
        for size in sizes:
            size = int(size)
            seed = []
            for d in range(3):
                hi = shape[d] - size
                seed.append(0 if hi < 0 else int(rng.integers(0, hi + 1)))
            lo = np.array(seed)
            hi = np.minimum(lo + size, np.array(shape))
            actual = tuple(int(h - l) for l, h in zip(lo, hi))
            if min(1 if a == 0 else a for a in actual) == 0 or max(actual) < 8:
                if verbose:
                    print(f"  REV sample {s_idx+1} size {size}: "
                          "skipped (small box)")
                continue
            boxes.append((s_idx + 1, size, tuple(int(v) for v in lo), actual))
    return boxes


# auto-batch threshold, in cells per crop, on the CPU: the JAX package's
# value, so that both packages route the same groups the same way
AUTO_BATCH_MAX_CELLS = 96 ** 3
# on a CUDA device: the largest crop at which the batched solver was faster
# than the sequential one that ``batch=False`` runs there (lanes up to
# 128^3, ``solve/lanes.py::CUDA_LANES_MAX_CELLS``).  Measured with
# scripts/torch_crossovers.py on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md, PR 13), crops of make_blobs(512, 0.4, 0), medians of 11 calls
# in turns, seconds batched / sequential with lanes: 64 x 64^3 1.214 /
# 6.335, 64 x 96^3 3.798 / 7.290, 48 x 112^3 4.557 / 5.848, 32 x 128^3
# 4.510 / 4.321, 24 x 160^3 6.597 / 4.335 (three calls: 16 x 192^3 7.495
# / 3.471, 8 x 256^3 9.063 / 2.939)
CUDA_AUTO_BATCH_MAX_CELLS = 112 ** 3


def auto_batch_max_cells(device="cpu") -> int:
    """The largest crop, in cells, that ``batch="auto"`` batches on
    ``device``."""
    if torch.device(device).type == "cuda":
        return CUDA_AUTO_BATCH_MAX_CELLS
    return AUTO_BATCH_MAX_CELLS


def _resolve_batch(batch, actual, n_group: int,
                   solve_kwargs=None, method: str = "cg",
                   precond: str = "auto", device="cpu") -> bool:
    """Per-group policy for ``batch="auto"``: batch only when there is more
    than one same-shape crop and each crop is small
    (``auto_batch_max_cells(device)``).  Callers requesting
    the exact float64 path (``inner_dtype=None``), a non-CG Krylov method,
    or an explicit preconditioner stay on the sequential solver: the
    batched solver hard-codes CG + Chebyshev, so "auto" must not silently
    override validated user configuration."""
    if isinstance(batch, str) and batch != "auto":
        # library callers may pass the config string through unconverted;
        # bool("false") is True, so parse the accepted tokens
        batch = batch.strip().lower() in ("true", "1", "yes", "on")
    if batch == "auto":
        if solve_kwargs and solve_kwargs.get("inner_dtype", "f32") is None:
            return False
        if str(method).lower() not in ("cg", "pcg") or precond != "auto":
            return False
        return n_group > 1 and math.prod(actual) <= auto_batch_max_cells(
            device)
    return bool(batch)


def _crop(phase, lo, actual):
    return phase[lo[0]:lo[0] + actual[0], lo[1]:lo[1] + actual[1],
                 lo[2]:lo[2] + actual[2]]


def _write_chi(plotfile_dir, s_no, size, chi, crop):
    """One sample's chi snapshot (``rev.write_plotfiles``)."""
    from ..io.writers import write_volume_hdf5_xdmf

    os.makedirs(plotfile_dir, exist_ok=True)
    base = os.path.join(plotfile_dir, f"rev_chi_s{s_no}_sz{size}")
    write_volume_hdf5_xdmf(base, {
        "chi_x": chi[0].cpu().numpy(),
        "chi_y": chi[1].cpu().numpy(),
        "chi_z": chi[2].cpu().numpy(),
        "phase": crop.astype(np.float64),
    })


@request("rev_study")
def rev_study(
    phase: np.ndarray,
    phase_id: int,
    sizes,
    num_samples: int = 3,
    eps: float = 1e-9,
    maxiter: int = 20000,
    method: str = "cg",
    precond: str = "auto",
    rng=None,
    csv_path: str | None = None,
    verbose: int = 0,
    batch: bool | str = "auto",
    plotfile_dir: str | None = None,
    **solve_kwargs,
):
    """Run the study; returns a list of RevSample and optionally streams a
    CSV (flushed row by row like the reference, ``Diffusion.cpp:498``, so
    partial studies survive a crash).

    ``batch``: ``True`` groups same-shape crops and solves each group's
    three cell problems as lanes of one batched program
    (``solve/batched.py``).  ``False`` runs the sequential multigrid solver
    per crop.  ``"auto"`` (default) decides per same-shape group by crop
    size (``auto_batch_max_cells``).  ``device`` (among ``solve_kwargs``):
    None means CUDA, ``"cpu"`` the CPU.  ``plotfile_dir``: write each
    sample's chi fields there as HDF5 + XDMF (``rev_chi_s<n>_sz<size>``,
    ``Diffusion.cpp:442-447``; needs h5py); the crops then run on the
    sequential solver, which returns the fields.  Every crop is solved on
    one device (``mesh=None`` unless ``solve_kwargs`` names one), also
    under a process group.
    """
    phase = np.asarray(phase)
    if rng is None:
        rng = np.random.default_rng(12345 + int(num_samples))
    with phase_timer(None, "draw"):
        boxes = _draw_samples(phase, sizes, num_samples, rng, verbose)

    groups: dict[tuple, list] = {}
    for idx, (s_no, size, lo, actual) in enumerate(boxes):
        groups.setdefault(actual, []).append(idx)

    results = {}
    dev = resolve_device(solve_kwargs.get("device"))
    for actual, idxs in groups.items():
        with phase_timer(None, "rev_group"):
            if plotfile_dir is None and _resolve_batch(
                    batch, actual, len(idxs), solve_kwargs, method=method,
                    precond=precond, device=dev):
                from ..solve.batched import batched_deff

                with phase_timer(None, "crop"):
                    crops = np.stack([_crop(phase, boxes[i][2], actual)
                                      for i in idxs])
                # the batched solver has its own preconditioner
                # (Chebyshev), so only the kwargs it understands are
                # forwarded
                bkw = {k: v for k, v in solve_kwargs.items() if k in (
                    "dx", "group_size", "budget_bytes", "inner_dtype",
                    "outer_dtype", "max_refine_rounds", "inner_round_cap",
                    "cheby_degree", "device")}
                if bkw.get("inner_dtype", "f32") is None:
                    # explicit batch=True + pure-f64 request: the batched
                    # solver always refines, so run its Krylov in f64
                    bkw["inner_dtype"] = torch.float64
                deffs, convs = batched_deff(crops, phase_id, eps=eps,
                                            maxiter=maxiter, **bkw)
                for j, i in enumerate(idxs):
                    d = deffs[j] if convs[j] else np.full((3, 3), math.nan)
                    results[i] = (d, bool(convs[j]))
                continue
            for i in idxs:
                s_no, size, lo, _ = boxes[i]
                crop = _crop(phase, lo, actual)
                # one device per crop, also under a process group: ranks
                # that call this may differ in plotfile_dir, so in path and
                # fields
                res = effective_diffusivity(
                    crop, phase_id, eps=eps, maxiter=maxiter, method=method,
                    precond=precond, verbose=max(0, verbose - 1),
                    return_fields=plotfile_dir is not None,
                    **{"mesh": None, **solve_kwargs},
                )
                d = res.deff if res.converged else np.full((3, 3), math.nan)
                results[i] = (np.asarray(d), res.converged)
                if plotfile_dir is not None and res.chi is not None:
                    _write_chi(plotfile_dir, s_no, size, res.chi, crop)

    out = []
    fh = open(csv_path, "w") if csv_path else None
    if fh:
        fh.write(CSV_HEADER + "\n")
        fh.flush()
    try:
        for i, (s_no, size, lo, actual) in enumerate(boxes):
            deff, conv = results[i]
            sample = RevSample(sample_no=s_no, seed=lo, size_target=size,
                               actual_size=actual, deff=np.asarray(deff),
                               converged=conv)
            out.append(sample)
            if verbose:
                print(f"  REV sample {s_no} size {size}: "
                      f"D_xx={deff[0,0]:.6f} converged={conv}")
            if fh:
                fh.write(csv_row(sample) + "\n")
                fh.flush()
    finally:
        if fh:
            fh.close()
    return out
