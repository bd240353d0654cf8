#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``openimpala_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, the 512^3 main path

Phases (each failure exits non-zero and prints no result line):

1. card      - the card's name and power limit (nvidia-smi), the versions,
               and the build of the CUDA kernels from ``csrc/`` by the
               solver warm-up's thread (``solve/warmup.py``), started
               before the volume is made and joined here (its build, load,
               launch and join seconds; ptxas register and spill report,
               kept beside each library); every name of the package
               surface (each subpackage's ``__all__`` and the root's)
               must resolve;
2. kernels   - every K1 mode (matvec, matvec+dot, resid, sweep, restrict)
               in float32 and float64 and every K2 mode (matvec, sweep,
               cheby, cheby_init), held against their plain PyTorch
               versions on odd, restrict-eligible, periodic and anisotropic
               systems; the fused dot must repeat bit for bit, and K2's
               cheby modes must equal the unfused sequence (K2 matvec and
               PyTorch's elementwise kernels) bit for bit.
               K1 again at the seams of its two routes (``K1_SEAMS``): the
               general route on extents of 1 to 3 and on rows that are not
               whole 16-byte vectors, the stream route on ragged tiles,
               short and uneven X runs, periodic seams and anisotropic
               packing, each case required to take the route it names.
               Every K3 mode (apply, the nearest-neighbour prefix apply,
               resid, sweep) with float32 and float64 ``x`` and full-
               precision and bfloat16 coefficients, on synthetic 33- and
               125-tap levels (odd extents, and extents below the taps'
               reach) and on the levels that ``SAMGPreconditioner`` builds
               for a clamped and a periodic system.  K4 (the explicit
               (diag, free) matvec, with and without the fused dot) on
               clamped, periodic and mixed axes, odd extents and extents 1
               and 2, a scalar, a per-lane and a full diag, float32 and
               float64, batches of 1, 3 and 64 lanes; the dots must repeat
               bit for bit; K5 (the streaming form) on the same unbatched
               cases, against the plain form and against K4;
3. perc      - ``percolation_mask(method="device")``, the bit-packed fill on
               the card, held against ``method="host"`` bit for bit (the
               same mask and the same ``active_vf``): on the main volume
               in X, Y and Z; on X extents that are not a multiple of 32
               (100^3 and 33 x 40 x 24); on a serpentine channel that
               needs many rounds; with an empty inlet face; all open.
               ``method="native"`` against the host on the main volume.
               The wall ms of each method per size from 128^3 up, the
               device fill's rounds, and the rule "auto" follows; the
               main volume's X mask is kept for the main paths;
4. main      - eleven main paths, each driven on its own: ``tortuosity`` on
               a 512^3 blobs volume (porosity 0.4, seed 0, direction X, eps
               1e-9) with the default preconditioner and dx = (1, 1, 1),
               which coarsens through K1 restrict; with dx = (1, 1, 2),
               which semi-coarsens and runs K1 resid; and with
               ``precond="sa"``, the smoothed-aggregation cycle, K1 on the
               fine level and K3 on every coarse level; and with
               ``precond="cheby"``, the Chebyshev polynomial on the explicit
               operator, kernel K5 (on a 256^3 volume of the same recipe,
               beside a default-path call there: at 512^3 it needs 951
               iterations and 37 s); with ``precond="mg"``, the
               rediscretised hierarchy, K1 on every level from 512^3 down
               to 4^3 (each extent must see K1, K2 must not launch); with
               the default cycle's options ``transfer="tri"``, ``cycle="w"``
               and ``smoother="cheby"`` (the last must launch no sweep
               kernel) on a 256^3 volume of the same recipe, beside the
               default-path call there (``OPTION_N``); and the port's CLI
               in-process on a uint8 RAW file
               of the volume (flow_through, X, solver_type = GMRES: FGMRES
               with the default cycle), whose ``results.txt`` is parsed
               back (its VolumeFraction must be ``volume_fraction``'s; the
               restart depth, the Arnoldi steps, the peak memory and the
               fields held beside the Krylov basis are logged; K1 matvec
               must launch at least once per Arnoldi step).  Each of
               these paths' tau must agree with the default path's to
               1e-6.  Then ``effective_diffusivity`` on the
               same 512^3 volume (three periodic cell problems: K1 and K2 on
               wrapped axes), and ``rev_study`` with 64 crops of 64^3 (one
               batched group, three directions: K4 over 64 lanes, with the
               fused dot in the PCG and without it in the polynomial and the
               float64 outer residual); one crop's tensor must agree with
               ``effective_diffusivity`` on that crop to 1e-6.  The launch
               counters are zeroed just before each call and read just
               after; each path must launch its kernels (the matvec+dot at
               least once per PCG iteration) while no plain version sees a
               CUDA tensor, every K1 launch at the path's fine extent must
               have taken the stream route, and the ``sa`` and ``cheby``
               paths' tau must agree with the default path's to 1e-6.
               Each ``tortuosity`` path logs the percolation method it
               took; where "auto" sends it to the card the device fill
               must have run, and at the main size its mask must equal the
               host's X mask of the ``perc`` phase.  ``effective_
               diffusivity`` logs whether the lockstep lanes ran (required
               where the card's rule takes them: ``lanes_pay``, up to
               128^3, and the memory gate ``use_lanes``) and is run again
               on the other path: the tensors must agree to 1e-9 and the
               iterations to 1 per direction.  ``rev_study`` logs the
               batch choice ``batch="auto"`` makes for its crops, which
               must be the card's table's (batched up to 112^3).  Every path
               runs its PCG iterations as CUDA graphs, as its entry point
               does (``utils/graphs.py``), logs ``graph: captures=,
               replays=, capture_s=`` and the iterations counted and
               executed in its Krylov calls (the refinement rounds):
               executed may pass counted by at most ``graphs.IN_FLIGHT``
               done-gated steps a call, and every executed step is a
               holder's eager first step or a replay.  It is run again as
               its eager twin (``graphs._eager_twin``): its result and
               iterations must be equal bit for bit, the twin must execute
               exactly the iterations it counts, as many as the graphed
               run counts, and every launch counter must be equal once the
               graphed run's steps past its counts are taken off; the
               results recorded before the iterations were graphed
               (``EAGER_RECORD``) are printed beside.  The CLI path's
               FGMRES stays eager (no capture, no twin), and its early
               warm-up must start no thread: the kernels are loaded.
               ``main[iso]`` takes the handle of ``prime_solver``, called
               with the JAX CLI's keywords and ``mesh="auto"`` (None: the
               kernels are loaded, so it must start no thread).
               Last, ``main[direct]``: ``tortuosity_direct`` on a 48^3
               blobs volume (porosity 0.6, X, eps 1e-6), each check a
               replay of one graph, held against the JAX package's value
               (``DIRECT_JAX``) to 1e-6 with the steps within one check;
               its first ``DIRECT_TWIN_CHECKS`` checks graphed against
               their eager twin, fields bit for bit; wall and steps per
               second;
4b. sharded  - the X-slab decomposition (``openimpala_tpu_torch/parallel/``):
               ``SHARDED_RANKS`` ranks spawned once the kernels are built
               and loaded here (``parallel.spawn``), each on its own X
               slab: ``gloo`` ranks on ``cuda:0`` (``nccl``, one rank per
               card, where the machine has as many cards); each rank reads
               its slab of the main volume from a uint8 RAW file
               (``io.ingest.threshold_sharded``) and runs ``tortuosity``
               (X, eps 1e-9) on it: tau within 1e-6 of ``main[iso]``,
               iterations within 2, active_vf equal, the flux conserved,
               every rank launching K1 matvec+dot, sweep and restrict and
               both K2 modes, no plain version on a CUDA tensor; per rank
               the wall, the steps, the peak memory, the halo exchanges
               and their bytes, the gathers and sums, the percolation
               method.  Each rank's ``volume_fraction_counts(local=True)``
               of its slab (no collective): the four pairs must sum to the
               mesh-reduced pair, whose total is the volume's cells.  Then
               each rank holds K1 (every mode, the fused dot)
               against its plain form on its ghost-padded slab of that
               system (``restrict`` pairing the slab's planes at the seam
               offset of the slab layout) and K2 (both modes) on the
               default cycle's sharded coarse levels, each padded by one
               plane with the seam conductance, and two smaller volumes go
               through the whole-volume path under the mesh against the
               single-device call here: 100^3 (slabs of 25 planes, odd:
               the cycle gathers at the fine level) and 254 x 256^2 (X
               padded to 256, the outlet at the original face, the cycle
               on the original's schedule), each with iterations within 2
               of the single-device call's.  ``sharded[deff]``:
               each rank passes the same slab of the main volume
               to ``effective_diffusivity`` (eps 1e-9, the periodic cell
               problems on slabs, the X wrap across the seam between the
               last rank and rank 0): the tensor within 1e-6 (of its
               largest entry) of ``main[deff]``'s, iterations within 2 per
               direction, the lockstep lanes taken where the rank-aware
               ``use_lanes`` gate admits them (it must at 512^3), the same
               bits on every rank, K1 matvec+dot, sweep, restrict and f64
               matvec and both K2 modes launched on every rank and no
               plain version on a CUDA tensor; per rank the wall, the
               steps, the peak memory, the halo, gather and sum traffic.
               K1 (every mode, the fused dot, rank 0's ghost the last
               rank's plane) and K2 (both modes, rank 0's ghost
               conductance the wrap's) are held against their plain forms
               again on the slab of that periodic cell problem, and their
               errors join the kernels line's K1 and K2 entries.  A rank's
               failure or the world's timeout fails the phase.  Then
               ``sharded[cli]``: the port's CLI under ``python -m
               torch.distributed.run --standalone --nproc_per_node 4``
               (gloo on the one card) on a 256 x 256 x 254 blobs volume
               written as an uncompressed multi-page TIFF
               (``calculation_method = homogenization``; Z = 254 does not
               divide by 4, so the Z-page split pads): return code 0, rank
               0's printed tensor within 1e-6 of a single-card
               ``effective_diffusivity`` call here on the same volume, no
               output from the other ranks, the ingest's all-to-all bytes
               logged, and each rank's launches in the calculation
               (``OPENIMPALA_LAUNCH_COUNTS``) held as ``sharded[deff]``'s
               are: K1 and K2 launched, no plain version on a CUDA tensor.
               Every preconditioner and Krylov method on the slabs, in
               the same world (``SHARDED_SOLVERS``): ``sharded[sa]`` and
               ``sharded[fgmres]`` (FGMRES with the default cycle) on the
               main volume's slabs from the RAW file, against ``main[sa]``
               and ``main[cli]``; ``sharded[mg]``, ``sharded[cheby]`` and
               ``sharded[deff-sa]`` (the periodic SA cell problems) on a
               ``SOLVER_N``^3 volume against single-card calls here: tau
               within 1e-6 (the tensor within 1e-6 of its largest entry),
               iterations or Arnoldi steps within 2, the same bits on
               every rank, each run's kernels on every rank (K3 at every
               sharded SA level's padded extent, K5 on the slab padded by
               one plane 7 times per iteration and no K4, K1 at every
               sharded ``mg`` level's extent in its slab layout and on the
               gathered levels), no plain version on a CUDA tensor; each
               logs its wall, peak and traffic per rank.  K3 (every mode,
               the prefix apply, and the slab forms) is held against its
               plain form on the R-padded slabs of the SA hierarchy built
               on the 512^3 flow slabs and on the periodic ``SOLVER_N``^3
               cell slabs (the build timed, its exchanges logged), and K5
               on the one-plane-padded slabs;
4c. graph    - at 128^3, ``tortuosity`` (default and ``sa``), the lanes of
               ``effective_diffusivity`` and ``rev_study`` (16 crops of
               64^3), graphed against the eager twin: results, iterations
               and every launch counter equal, iterations counted and
               executed held as on the main paths;
4d. rules    - ``maxiter`` as a hard cap, at 128^3: ``tortuosity`` with
               ``maxiter=20`` under ``precond="auto"`` and ``"jacobi"``
               must stop at exactly 20 iterations, unconverged, tau NaN;
               ``effective_diffusivity`` with ``maxiter=12``, with and
               without the lanes, no direction past 12;
5. parity    - the same call at 64^3 on the GPU and on the CPU:
               ``tortuosity`` with the default and with the ``sa``
               preconditioner, with ``mg`` (in float64, where the
               iterations must agree to 1), with each option of the
               default cycle and with ``method="fgmres"``, and
               ``effective_diffusivity`` with the default, the ``mg``
               preconditioner (the periodic constant codes) and FGMRES;
6. times     - for each path, its kernels against their plain versions on
               that path's own 512^3 system and coarse levels (K3 on every
               level of the ``sa`` path's hierarchy, each with the launches
               the run made at that extent): max error, the kernel's time
               from a CUDA graph (``ms``) and back to back from the host
               (``ms_eager``), the plain version's time, the
               compulsory-bytes bound and launches per PCG iteration (per
               Arnoldi step on the CLI path); K1 on every level of the
               ``mg`` path's hierarchy, on that level's own code, with the
               launches at that extent, the route taken, the bound and the
               general route's time; K1
               with the route it took and the general route's time on the
               same input beside it (timed only).  K5
               is timed on the ``cheby`` path's own (diag, free) with K4
               (full diag, scalar diag, with the dot) beside it on the same
               input, and the two again side by side at 512^3 on the
               default path's system; K4 on the ``rev`` path's 64 x 64^3
               batch.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``.  Volumes are made with
numpy from a seed; fields on the card from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from openimpala_tpu_torch.ops.offset_cuda import k3_cost
from openimpala_tpu_torch.ops.stencil_cuda import k1_cost
from openimpala_tpu_torch.utils.sample_data import make_blobs

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 and f64
# vector rates.  The bound of a kernel is the larger of bytes / bandwidth
# and flops / rate.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 67e12, torch.float64: 34e12}

SEED = 0  # volumes and fields are made from it
# (rtol, atol) of a kernel against its plain version
TOL = {torch.float32: (1e-5, 1e-5), torch.float64: (1e-12, 1e-12)}
# relative tolerance of the fused dot (summed in double) against the plain
# sum in the working dtype
DOT_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}

# K3 float32: a sum of up to 125 products, held to the tolerance the JAX
# package's own kernel test uses; the kernel and the plain form differ by
# FMA contraction only
K3_TOL = {torch.float32: (2e-5, 2e-5), torch.float64: (1e-12, 1e-12)}

K1_SRC = "openimpala_tpu_torch/csrc/k1_stencil.cu"
K2_SRC = "openimpala_tpu_torch/csrc/k2_conductance.cu"
K1_TPU = "openimpala_tpu/ops/stencil_pallas.py:815"
K2_TPU = "openimpala_tpu/ops/stencil_pallas.py:757"
# K2's cheby modes replace no Pallas kernel: they fuse the loop body of the
# JAX package's Chebyshev iteration, which runs around K2's kernel
K2_CHEBY_TPU = ("openimpala_tpu/solve/preconditioners.py:657 "
                "(_smooth_cheby's loop body)")
K3_SRC = "openimpala_tpu_torch/csrc/k3_offset.cu"
K3_TPU = "openimpala_tpu/ops/offset_pallas.py:170"
K4_SRC = "openimpala_tpu_torch/csrc/k4_matvec.cu"
K4_TPU = "openimpala_tpu/ops/stencil_pallas.py:124"
K5_SRC = "openimpala_tpu_torch/csrc/k5_matvec_stream.cu"
K5_TPU = "openimpala_tpu/ops/stencil_pallas.py:297"

# compulsory bytes and flops per (fine) cell of each kernel on the main
# paths; K3's depend on the taps of the level the run built (k3_cost); K4
# and K5 read a full-array diag on their paths (x, diag, free, out)
def _k1(mode, dtype):
    """K1's table entry, its bytes and flops per cell from ``k1_cost``."""
    nbytes, flops = k1_cost(mode, (1, 1, 1), dtype)
    return (K1_SRC, K1_TPU, nbytes, flops, dtype)


PATH_KERNELS = {
    # name: (source, replaces, bytes/cell, flops/cell, dtype)
    "k1_matvec_dot_f32": _k1("matvec_dot", torch.float32),
    "k1_matvec_f32": _k1("matvec", torch.float32),
    "k1_resid_f32": _k1("resid", torch.float32),
    "k1_sweep_f32": _k1("sweep", torch.float32),
    "k1_restrict_f32": _k1("restrict", torch.float32),
    "k1_matvec_f64": _k1("matvec", torch.float64),
    "k2_matvec_f32": (K2_SRC, K2_TPU, 24.0, 16, torch.float32),
    "k2_sweep_f32": (K2_SRC, K2_TPU, 28.0, 20, torch.float32),
    "k2_cheby_f32": (K2_SRC, K2_CHEBY_TPU, 40.0, 22, torch.float32),
    "k2_cheby_init_f32": (K2_SRC, K2_CHEBY_TPU, 20.0, 4, torch.float32),
    "k3_apply_f32": (K3_SRC, K3_TPU, None, None, torch.float32),
    "k3_apply_prefix_f32": (K3_SRC, K3_TPU, None, None, torch.float32),
    "k3_resid_f32": (K3_SRC, K3_TPU, None, None, torch.float32),
    "k3_sweep_f32": (K3_SRC, K3_TPU, None, None, torch.float32),
    "k4_matvec_dot_f32": (K4_SRC, K4_TPU, 13.0, 12, torch.float32),
    "k4_matvec_f32": (K4_SRC, K4_TPU, 13.0, 10, torch.float32),
    "k4_matvec_f64": (K4_SRC, K4_TPU, 25.0, 10, torch.float64),
    "k5_matvec_f32": (K5_SRC, K5_TPU, 13.0, 10, torch.float32),
}
_K1 = ("k1_matvec_dot_f32", "k1_matvec_f32", "k1_sweep_f32", "k1_matvec_f64")
_K2 = ("k2_matvec_f32", "k2_sweep_f32", "k2_cheby_f32", "k2_cheby_init_f32")
_K3 = ("k3_apply_f32", "k3_apply_prefix_f32", "k3_resid_f32", "k3_sweep_f32")
_K4 = ("k4_matvec_dot_f32", "k4_matvec_f32", "k4_matvec_f64")
_ISO = (1.0, 1.0, 1.0)
# the main paths, each driven and counted on its own: label -> (entry
# point, dx, precond, precond_opts, the kernels it must launch).  "tau" is
# ``tortuosity``: isotropic spacing coarsens 2x2x2 through K1 restrict;
# dx = (1, 1, 2) semi-coarsens, so its fine level runs K1 resid; "sa" runs K1
# resid and two more matvecs per cycle on the fine level (the smoothed
# transfers) and K3 on every coarse level: the full apply while probing,
# the prefix apply in the transfers of level 1; "cheby" applies the
# polynomial through K5 and keeps K1 for the PCG's own matvec and the
# residuals.  "mg" is the rediscretised hierarchy, K1 on every level from
# the fine one down to 4^3 and no K2.  The three "gmg-*" paths are the
# default cycle with one option each: trilinear transfers (K1 resid, then
# the restriction as tensor code), the W-cycle (K2 twice per visit down to
# w_depth), the Chebyshev smoother (K1 applies its operator, K2 runs its
# cheby steps; no sweep kernel runs).  Every Galerkin path solves its
# coarsest level with K2's cheby steps (one launch a step, no K2 matvec
# there).  "cli" is the port's CLI on a RAW file, solver_type =
# GMRES: FGMRES with the default cycle, K1 matvec per Arnoldi step.
# "deff" is ``effective_diffusivity``: the default cycle on three periodic
# systems.  "rev" is ``rev_study``: the batched solver, K4 over the lanes.
PATHS = {
    "iso": ("tau", _ISO, "auto", None, _K1 + _K2 + ("k1_restrict_f32",)),
    "aniso": ("tau", (1.0, 1.0, 2.0), "auto", None,
              _K1 + _K2 + ("k1_resid_f32",)),
    "sa": ("tau", _ISO, "sa", None, _K1 + _K3 + ("k1_resid_f32",)),
    "cheby": ("tau", _ISO, "cheby", None,
              ("k1_matvec_dot_f32", "k1_matvec_f32", "k1_matvec_f64",
               "k5_matvec_f32")),
    "mg": ("tau", _ISO, "mg", None, _K1 + ("k1_restrict_f32",)),
    "gmg-tri": ("tau", _ISO, "auto", {"transfer": "tri"},
                _K1 + _K2 + ("k1_resid_f32",)),
    "gmg-w": ("tau", _ISO, "auto", {"cycle": "w"},
              _K1 + _K2 + ("k1_restrict_f32",)),
    "gmg-cheby": ("tau", _ISO, "auto", {"smoother": "cheby"},
                  ("k1_matvec_dot_f32", "k1_matvec_f32", "k1_matvec_f64",
                   "k1_restrict_f32", "k2_matvec_f32", "k2_cheby_f32",
                   "k2_cheby_init_f32")),
    "cli": ("cli", _ISO, "auto", None,
            ("k1_matvec_f32", "k1_sweep_f32", "k1_restrict_f32",
             "k1_matvec_f64") + _K2),
    "deff": ("deff", _ISO, "auto", None, _K1 + _K2 + ("k1_restrict_f32",)),
    "rev": ("rev", _ISO, None, None, _K4),
}
assert {k for *_, ks in PATHS.values() for k in ks} == set(PATH_KERNELS)
# the paths whose tau must agree with main[iso]'s to 1e-6
AGREE_WITH_ISO = ("sa", "mg", "gmg-tri", "gmg-w", "gmg-cheby", "cli")

# the REV path: the JAX package's own batched configuration, 64 crops of
# 64^3 in one group, three directions
REV_SIZE, REV_SAMPLES = 64, 64
CHEBY_DEGREE_BATCHED = 12  # cheby_degree default of batched_cell_problems
CHEBY_DEGREE = 8  # degree default of ChebyshevPreconditioner
# edge of the volume the "cheby" path runs on, with a default-path call
# beside it at the same edge.  At 512^3 this opt-in preconditioner needs 951
# PCG iterations and 36.8 s of inner rounds on an H100 (700 W), at 256^3
# 494 and 2.6 s (scripts/profile_torch_solve.py --precond cheby [--n 256]),
# so the path runs at 256^3; K5 and K4 are still timed side by side at the
# full 512^3 on the default path's system.
CHEBY_N = 256


# edge of the volume the default cycle's options ("gmg-*") run on, beside
# the default-path call there that the "cheby" path makes: with them at
# 512^3 and each path run again as its eager twin, the whole script's warm
# wall passed 180 s (240.0 s on an H100, PERF.md), the limit past which
# they move to 256^3
OPTION_N = 256

# The results recorded before the solvers' chunks ran as CUDA graphs
# (eager chunks; NVIDIA H100 80GB HBM3, 700 W; PERF.md): tau (D_xx for
# deff, the mean D_xx for rev), the iterations (their sum over the
# directions for deff; Arnoldi steps for cli) and the volume's edge,
# printed beside this run's where it ran on that volume
EAGER_RECORD = {
       "iso": (2.6095680474199647, 50, 512),
       "aniso": (3.445989861577157, 52, 512),
       "sa": (2.609568050470971, 82, 512),
       "cheby": (2.6890563461652963, 494, 256),
       "mg": (2.6095680922036535, 890, 512),
       "gmg-tri": (2.609568050413385, 183, 512),
       "gmg-w": (2.6095680347203927, 49, 512),
       "gmg-cheby": (2.6095680592259582, 50, 512),
       "cli": (2.6095680398990324, 62, 512),
       "deff": (0.4056992575210027, 48, 512),
       "rev": (0.4072245571540461, None, 512)}

# main[direct]: ``tortuosity_direct(make_blobs(48, 0.6, 0), 1, "X",
# eps=1e-6)``, held against the JAX package's value for the same call
# (``python3 -m scripts.direct_reference``: openimpala_tpu.props.
# tortuosity_direct, float64, on an x86 CPU, JAX 0.9.0) to 1e-6 relative,
# with the steps equal or one check (plot_interval + 1 = 101) apart
DIRECT_N = 48
DIRECT_JAX = {"value": -2.7714819921465814, "iterations": 43531,
              "residual": 9.9128850616742e-07}
DIRECT_CHECK = 101
# its eager twin runs this many checks of the same call, against as many
# graphed ones: the fields, residual and fluxes must be equal bit for bit
# (the whole eager solve takes 14-28 s, host-bound at about 25 launches
# per step)
DIRECT_TWIN_CHECKS = 10

# the graph check: each of these paths on a 128^3 volume, graphed against
# its eager twin (result, iterations and every launch counter equal)
GRAPH_N = 128
# the rules phase's caps: below what the GRAPH_N^3 solves need (tau 46
# iterations, each cell problem 16)
RULES_TAU_MAXITER = 20
RULES_DEFF_MAXITER = 12
GRAPH_REV_SAMPLES = 16


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def _phase_done(name, t0) -> float:
    t = time.perf_counter()
    log(f"phase {name}: {t - t0:.1f} s")
    return t


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls.  The window includes the
    host's cost of enqueueing each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``reps`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events, so
    the host's per-launch cost stays out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


class Checker:
    """Holds kernel outputs against plain ones and keeps each name's
    largest absolute error."""

    def __init__(self):
        self.max_err: dict = {}
        self.cases: dict = {}

    def close(self, name, got, want, dtype, case, tol=TOL, scale=1.0):
        """``scale``: the size of the terms the output sums, where that is
        not O(1); the absolute tolerance is taken in its units."""
        rtol, atol = tol[dtype]
        atol *= scale
        require(got.shape == want.shape,
                f"{name} [{case}]: shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max())
        ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        self.cases.setdefault(name, []).append(case)
        require(ok, f"{name} [{case}]: max abs err {err:.3e} beyond "
                    f"rtol={rtol} atol={atol}")

    def dot(self, name, got, want, dtype, case, floor=1e-300):
        """The fused dot (0-d, or one per lane) against the plain sum: the
        largest relative difference.  ``floor``: the size of the terms the
        dot sums, where they cancel (an axis of extent 1 or 2 that wraps
        onto itself makes the operator singular and <x, Ax> pure
        rounding); the difference is then taken relative to it."""
        require(got.shape == want.shape,
                f"{name} [{case}]: dot shape {tuple(got.shape)} != "
                f"{tuple(want.shape)}")
        g, w = got.double(), want.double()
        rel = float(((g - w).abs() / w.abs().clamp_min(floor)).max())
        self.max_err[name + ".dot_rel"] = max(
            self.max_err.get(name + ".dot_rel", 0.0), rel)
        require(rel <= DOT_RTOL[dtype],
                f"{name} [{case}]: dot {g.flatten()[:4].tolist()!r} vs plain "
                f"{w.flatten()[:4].tolist()!r} (rel {rel:.3e})")


def _tag(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def check_k1(chk, system, gen, dtype, case, modes=None, cancelling=False,
             **plan):
    """Every K1 mode in ``modes`` on one system against the plain forms;
    ``plan`` (route, run, rows) overrides the launcher's own plan.
    ``cancelling``: the system is singular (tiny wrapped extents), so the
    dot is held relative to its diagonal terms, sum(d x^2)."""
    import functools

    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    k1 = functools.partial(sc.k1_stencil, **plan)

    code, w, per = system.code, system.w, system.periodic
    free = system.free
    shape = tuple(code.shape)
    zero = torch.zeros((), dtype=dtype, device=code.device)
    x = torch.where(free, torch.randn(shape, generator=gen, dtype=dtype,
                                      device=code.device), zero)
    r = torch.where(free, torch.randn(shape, generator=gen, dtype=dtype,
                                      device=code.device), zero)
    tag = _tag(dtype)
    even = all(s % 2 == 0 for s in shape)
    modes = modes or ("matvec_dot", "matvec", "resid", "sweep", "restrict")
    if "matvec_dot" in modes:
        out, dot = k1("matvec", x, None, code, w, per, with_dot=True)
        out2, dot2 = k1("matvec", x, None, code, w, per, with_dot=True)
        require(torch.equal(out, out2) and torch.equal(dot, dot2),
                f"k1_matvec_dot_{tag} [{case}]: two runs differ")
        want, wdot = st.apply_code_with_dot_plain(x, code, w, per)
        chk.close(f"k1_matvec_dot_{tag}", out, want, dtype, case)
        floor = 1e-300
        if cancelling:
            floor += float((x.double() ** 2).sum()) * 2.0 * sum(w)
        chk.dot(f"k1_matvec_dot_{tag}", dot, wdot, dtype, case, floor=floor)
    if "matvec" in modes:
        chk.close(f"k1_matvec_{tag}",
                  k1("matvec", x, None, code, w, per),
                  st.apply_code_plain(x, code, w, per), dtype, case)
    if "resid" in modes:
        chk.close(f"k1_resid_{tag}",
                  k1("resid", x, r, code, w, per),
                  st.residual_restricted_plain(x, r, code, w, per), dtype,
                  case)
    if "sweep" in modes:
        chk.close(f"k1_sweep_{tag}",
                  k1("sweep", x, r, code, w, per, omega=0.9),
                  st.smooth_sweep_plain(x, r, code, w, per, 0.9), dtype,
                  case)
    if "restrict" in modes and even:
        chk.close(f"k1_restrict_{tag}",
                  k1("restrict", x, r, code, w, per),
                  st.residual_restrict_plain(x, r, code, w, per), dtype,
                  case)
    return x, r


def check_k2(chk, level, gen, case):
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    dtype = level.diag.dtype
    shape = tuple(level.diag.shape)
    dev = level.diag.device
    x = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    r = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    tag = _tag(dtype)
    # A Galerkin level's coefficients grow fourfold per level (a periodic
    # 512^3 system's level 2 holds diagonals of several hundred), so the
    # matvec sums terms that large and cancels them; kernel and plain form
    # round them in another order.  The absolute tolerance is 1e-5 (1e-12)
    # of the level's largest diagonal entry.
    scale = max(1.0, float(level.diag.max()))
    chk.close(f"k2_matvec_{tag}",
              sc.k2_conductance("matvec", x, None, level.cx, level.cy,
                                level.cz, level.diag),
              level.apply_plain(x), dtype, case, scale=scale)
    chk.close(f"k2_sweep_{tag}",
              sc.k2_conductance("sweep", x, r, level.cx, level.cy, level.cz,
                                level.diag, omega=0.9),
              level.sweep_plain(x, r, 0.9), dtype, case)
    check_k2_cheby(chk, level, x, r, case, scale)
    return x, r


def _cheby_unfused(level, res, d, x, c1, c2, init):
    """One Chebyshev step as K2 matvec and PyTorch's elementwise kernels
    (seven launches; the zero start: res = r - A 0, d = inv_d*res*c1,
    x = 0 + d): what K2's cheby modes fuse."""
    diag = level.diag
    inv_d = torch.where(level.free & (diag > 0),
                        1.0 / torch.where(diag > 0, diag, 1.0),
                        torch.zeros((), dtype=diag.dtype, device=diag.device))
    if init:
        zero = torch.zeros_like(res)
        res = res - level.apply(zero)
        d = inv_d * res * c1
        return res, d, zero + d
    res = res - level.apply(d)
    d = c1 * d + c2 * (inv_d * res)
    return res, d, x + d


def check_k2_cheby(chk, level, x, r, case, scale):
    """K2's cheby and cheby_init modes against their plain forms, and to
    the bit against the unfused sequence on the card."""
    dtype = level.diag.dtype
    tag = _tag(dtype)
    ft = np.float32 if dtype == torch.float32 else np.float64
    c0, c1, c2 = (float(ft(v)) for v in (0.9, 1.05, 0.48))
    got = level.cheby_init(r, c0)
    for g, p in zip(got, level.cheby_init_plain(r, c0)):
        chk.close(f"k2_cheby_init_{tag}", g, p, dtype, case)
    want = _cheby_unfused(level, r, None, None, c0, None, True)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"k2_cheby_init_{tag} [{case}]: not the unfused sequence's bits")
    state = (r, x, x * 0.5)
    got = level.cheby_step(*(t.clone() for t in state), c1, c2)
    for g, p in zip(got, level.cheby_step_plain(*state, c1, c2)):
        chk.close(f"k2_cheby_{tag}", g, p, dtype, case, scale=scale)
    want = _cheby_unfused(level, *state, c1, c2, False)
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"k2_cheby_{tag} [{case}]: not the unfused sequence's bits")


def synthetic_offset_level(rng, shape, taps, dtype, device):
    """A packed offset level with random coefficients, made with numpy:
    33 taps (the l_inf<=1 ball and the axial +-2 taps, the support of SA
    level 1) or 125 (every offset of [-2, 2]^3, level 2).  The diagonal has
    exact zeros (the resid and sweep masks) and stays away from (0, 0.9),
    where omega/d would amplify rounding."""
    from openimpala_tpu_torch.ops.offset import order_offsets
    from openimpala_tpu_torch.solve.sa import OffsetLevel

    rad = range(-2, 3)
    sup = [(i, j, k) for i in rad for j in rad for k in rad]
    if taps == 33:
        sup = [o for o in sup if max(map(abs, o)) <= 1
               or sum(map(abs, o)) == 2 == max(map(abs, o))]
    offsets, nn = order_offsets(sup)
    require(len(offsets) == taps and offsets[0] == (0, 0, 0),
            f"synthetic level: {len(offsets)} taps for {taps}")
    c = rng.standard_normal((shape[0], taps) + tuple(shape[1:]))
    c[:, 0] = np.where(np.abs(c[:, 0]) < 0.3, 0.0, 3.0 * c[:, 0])
    packed = torch.from_numpy(c).to(device=device, dtype=dtype)
    return OffsetLevel(packed=packed, offsets=offsets, nn=nn)


def check_k3(chk, lvl, gen, case, xdtypes):
    """Every K3 mode, and the nearest-neighbour prefix apply, on one
    OffsetLevel against the plain forms, for each ``x`` dtype given (the
    coefficients are ``lvl.packed``'s: bfloat16 or the dtype of ``x``)."""
    from openimpala_tpu_torch.ops import offset as po
    from openimpala_tpu_torch.ops import offset_cuda as oc

    pk, offs = lvl.packed, lvl.offsets
    shape = tuple(lvl.diag.shape)
    ctag = "bf16" if pk.dtype == torch.bfloat16 else "full"
    for dtype in xdtypes:
        x = torch.randn(shape, generator=gen, dtype=dtype, device=pk.device)
        r = torch.randn(shape, generator=gen, dtype=dtype, device=pk.device)
        tag, c = _tag(dtype), f"{case} coeff {ctag}"
        chk.close(f"k3_apply_{tag}", oc.k3_offset("apply", x, None, pk, offs),
                  po.offset_apply_plain(x, pk, offs), dtype, c, tol=K3_TOL)
        if lvl.nn < len(offs):
            chk.close(f"k3_apply_prefix_{tag}",
                      oc.k3_offset("apply", x, None, pk, offs, n_taps=lvl.nn),
                      po.offset_apply_plain(x, pk, offs, n_taps=lvl.nn),
                      dtype, c, tol=K3_TOL)
        chk.close(f"k3_resid_{tag}", oc.k3_offset("resid", x, r, pk, offs),
                  po.offset_resid_plain(x, r, pk, offs), dtype, c, tol=K3_TOL)
        chk.close(f"k3_sweep_{tag}",
                  oc.k3_offset("sweep", x, r, pk, offs, omega=0.9),
                  po.offset_sweep_plain(x, r, pk, offs, 0.9), dtype, c,
                  tol=K3_TOL)
    return x, r


def _bf16(lvl):
    return dataclasses.replace(lvl, packed=lvl.packed.to(torch.bfloat16))


def check_restricted(chk, x, diag, free, w, per, case):
    """K4 (without and with the fused dot) on one input against the plain
    form; the dot must repeat bit for bit.  Where K5 can take the input (one
    volume, full diag) it is held against the plain form and against K4."""
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    dtype, tag = x.dtype, _tag(x.dtype)
    want, wdot = st.apply_restricted_with_dot_plain(x, diag, free, w, per)
    out = sc.k4_matvec(x, diag, free, w, per)
    chk.close(f"k4_matvec_{tag}", out, want, dtype, case)
    out_d, dot = sc.k4_matvec(x, diag, free, w, per, with_dot=True)
    out_d2, dot2 = sc.k4_matvec(x, diag, free, w, per, with_dot=True)
    require(torch.equal(out_d, out_d2) and torch.equal(dot, dot2),
            f"k4_matvec_dot_{tag} [{case}]: two runs differ")
    chk.close(f"k4_matvec_dot_{tag}", out_d, want, dtype, case)
    chk.dot(f"k4_matvec_dot_{tag}", dot, wdot, dtype, case)
    if st.restricted_kernel(x, diag, False) == "k5":
        k5 = sc.k5_matvec_stream(x, diag, free, w, per)
        chk.close(f"k5_matvec_{tag}", k5, want, dtype, case)
        chk.close(f"k5_against_k4_{tag}", k5, out, dtype, case)


def phase_kernels_restricted(chk, gen, dev):
    """K4 and K5 on synthetic inputs: every combination of boundary, extent,
    diag form, dtype and batch listed in the module docstring.  The diag
    stays above 2 * sum(w), so <x, Ax> is a sum of positive terms and its
    relative error means something."""
    pers = {"clamped": (False, False, False), "periodic": (True, True, True),
            "mixed": (True, False, True)}
    shapes = ((33, 20, 17), (16, 24, 40), (1, 2, 3), (2, 1, 1), (5, 1, 2))
    for w in ((1.0, 1.0, 1.0), (1.0, 4.0, 0.25)):
        base = 2.0 * sum(w) + 0.5
        for (pname, per), shape, dtype, lanes in (
                (pp, sh, dt, ln) for pp in pers.items() for sh in shapes
                for dt in (torch.float32, torch.float64)
                for ln in (0, 1, 3, 64)):
            if lanes == 64 and shape[0] > 16:
                continue  # the 64-lane batch on the smaller extents only
            full = ((lanes,) if lanes else ()) + shape
            x = torch.randn(full, generator=gen, dtype=dtype, device=dev)
            free = torch.rand(full, generator=gen, device=dev) < 0.7
            diags = {"scalar": torch.full((), base, dtype=dtype, device=dev),
                     "full": base + torch.rand(full, generator=gen,
                                               dtype=dtype, device=dev)}
            if lanes:
                diags["lane"] = base + torch.rand(
                    (lanes,), generator=gen, dtype=dtype, device=dev)
            for form, diag in diags.items():
                # the mask as bool and as int8, by turns
                mask = free if form != "full" else free.to(torch.int8)
                check_restricted(
                    chk, x, diag, mask, w, per,
                    f"{pname} {'x'.join(map(str, shape))} lanes {lanes} "
                    f"diag {form} w {w}")


# K1 at the seams of its two routes: (case, shape, kind, dx, overrides of
# the launcher's plan).  The general route on extents of 1 to 3 and on rows
# that are not whole 16-byte vectors; the stream route (forced, the
# volumes being too small to be sent there by the rule) on a ragged last
# tile along Z and along Y, fewer rows than a tile, X shorter than a run,
# X = 4 runs + 1, odd periodic extents, anisotropic packing, one row per
# thread on clamped axes and two on periodic ones.
K1_SEAMS = [
    ("1x1x1 periodic", (1, 1, 1), "cell", (1, 1, 1), {}),
    ("2x2x2 periodic", (2, 2, 2), "cell", (1, 1, 1), {}),
    ("3x2x1 periodic", (3, 2, 1), "cell", (1, 0.5, 2), {}),
    ("3x2x1 clamped", (3, 2, 1), "flow", (1, 1, 1), {}),
    ("Z = tile + 1", (16, 24, 129), "flow", (1, 1, 1), {}),
    ("Z = tile - 1", (16, 24, 127), "cell", (1, 1, 1), {}),
    ("one tile, X under a run", (16, 24, 128), "flow", (1, 1, 1),
     {"route": "stream"}),
    ("Z = tile + 4", (16, 24, 132), "flow", (1, 1, 1), {"route": "stream"}),
    ("Z = 2 tiles - 4, periodic", (16, 24, 252), "cell", (1, 1, 1),
     {"route": "stream"}),
    ("Y under a tile, aniso periodic", (6, 4, 128), "cell", (1, 0.5, 2),
     {"route": "stream"}),
    ("X = 4 runs + 1, Z ragged", (65, 20, 516), "flow", (1, 1, 1),
     {"route": "stream", "run": 16}),
    ("X = 8 runs + 6", (70, 20, 516), "flow", (1, 1, 1),
     {"route": "stream", "run": 8}),
    ("odd periodic X and Y", (33, 17, 260), "cell", (1, 1, 1),
     {"route": "stream", "run": 16}),
    ("1x1 rows periodic", (1, 1, 128), "cell", (1, 1, 1),
     {"route": "stream"}),
    ("2x2 rows periodic", (2, 2, 128), "cell", (1, 1, 1),
     {"route": "stream"}),
    ("aniso 128x64x256", (128, 64, 256), "flow", (1, 0.5, 2),
     {"route": "stream"}),
    ("aniso periodic 64x48x256, two rows", (64, 48, 256), "cell",
     (1, 0.5, 2), {"route": "stream", "rows": 2, "run": 22}),
    ("clamped 64x48x256, one row", (64, 48, 256), "flow", (1, 1, 1),
     {"route": "stream", "rows": 1, "run": 20}),
]


def phase_kernels_k1_seams(chk, gen, dev, rng):
    """Every K1 mode, float32 and float64, on ``K1_SEAMS`` against the plain
    forms; the stream route also against the general one (logged)."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system, make_tortuosity_system)

    worst = 0.0
    for case, shape, kind, dx, plan in K1_SEAMS:
        mask = torch.from_numpy(rng.random(shape) < 0.7).to(dev)
        for dtype in (torch.float32, torch.float64):
            if kind == "flow":
                system = make_tortuosity_system(mask, 0, -1.0, 1.0, dx=dx,
                                                dtype=dtype)
            else:
                system = make_cell_problem_system(mask, 1, dx=dx, dtype=dtype)
            modes = ["matvec_dot", "matvec", "resid", "sweep"]
            if plan.get("rows", 2) == 2 and all(n % 2 == 0 for n in shape):
                modes.append("restrict")
            before = dict(sc.launches_route)
            x, r = check_k1(chk, system, gen, dtype,
                            f"seam {case} {plan}", modes=modes,
                            cancelling=kind == "cell" and min(shape) <= 2,
                            **plan)
            took = {k[1] for k, v in sc.launches_route.items()
                    if v != before.get(k, 0)}
            want = plan.get("route", "general")
            require(took == {want}, f"k1 seam [{case}]: took the routes "
                                    f"{sorted(took)}, not {want}")
            if want != "stream":
                continue
            code, w, per = system.code, system.w, system.periodic
            for m in modes[1:]:  # the dot's matvec is the plain matvec
                a = sc.k1_stencil(m, x, r, code, w, per, **plan)
                b = sc.k1_stencil(m, x, r, code, w, per, route="general")
                worst = max(worst, float((a.double() - b.double()).abs()
                                         .max()))
    torch.cuda.synchronize()
    log(f"k1 seams: {len(K1_SEAMS)} cases x 2 dtypes; the stream route "
        f"against the general route, largest abs difference {worst:.3e}")


def phase_card(warm):
    """``warm``: the warm-up thread that builds every kernel while the
    volume is made (``solve/warmup.py``), joined here."""
    from openimpala_tpu_torch.io import native
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    log(card_line())
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}  "
        f"count {torch.cuda.device_count()}")
    try:
        warm.join()
    except RuntimeError as e:
        raise SmokeFailure(f"card: the kernels' build failed: {e}") from e
    t = warm.timing
    log(f"warm-up thread: kernels {t['kernels']} built {t['built']} "
        f"build_s={t['build_s']:.3f} load_s={t['load_s']:.3f} "
        f"launch_s={t['launch_s']:.3f}; join() waited {t['join_s']:.3f} s")
    t0 = time.perf_counter()
    built = sc.build()
    log(f"build: {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        "(built by the warm-up thread: one nvcc per source, in parallel, "
        "or the cached library)")
    for name, (path, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    lib = native.require_lib()
    log(f"native library {lib._name} in {time.perf_counter() - t0:.1f} s")
    _require_surface()


# the subpackages whose ``__all__`` mirrors the JAX package's
# (``tests/test_torch_surface.py`` holds the lists against it)
SURFACE = ("io", "ops", "parallel", "props", "solve", "utils")
SURFACE_ROOT = ("ops", "parallel", "props", "solve", "volume_fraction",
                "tortuosity", "effective_diffusivity", "deff_tensor")


def _require_surface():
    """Every name of every subpackage's ``__all__``, and the root's,
    resolves on this machine."""
    import importlib

    import openimpala_tpu_torch as root

    missing = [n for n in SURFACE_ROOT if not hasattr(root, n)]
    count = len(SURFACE_ROOT)
    for sub in SURFACE:
        pkg = importlib.import_module(f"openimpala_tpu_torch.{sub}")
        names = getattr(pkg, "__all__", ())
        require(names, f"card: openimpala_tpu_torch.{sub} has no __all__")
        missing += [f"{sub}.{n}" for n in names if not hasattr(pkg, n)]
        count += len(names)
    require(not missing, f"card: names of the package surface do not "
                         f"resolve: {missing}")
    log(f"package surface: {count} names of the root and "
        f"{len(SURFACE)} subpackages resolve")


def phase_kernels(chk, seed):
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system, make_tortuosity_system)
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner, fine_conductances)
    from openimpala_tpu_torch.solve.sa import SAMGPreconditioner

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    both = (torch.float32, torch.float64)
    # K3 on synthetic levels: an odd extent, 4^3 (taps at +-2 reach half
    # the extent) and 3x2x1 (taps beyond the extent)
    for shape in ((25, 18, 17), (4, 4, 4), (3, 2, 1)):
        for taps in (33, 125):
            case = f"synthetic {taps} taps " + "x".join(map(str, shape))
            for dtype in both:
                lvl = synthetic_offset_level(rng, shape, taps, dtype, dev)
                check_k3(chk, lvl, gen, case, (dtype,))
            check_k3(chk, _bf16(lvl), gen, case, both)
    # K3 on the levels SAMGPreconditioner builds (K1 and K3 do the probing)
    for case, shape, kind in (("sa clamped 48x40x32", (48, 40, 32), "flow"),
                              ("sa periodic 40x40x40", (40, 40, 40), "cell")):
        mask = torch.from_numpy(rng.random(shape) < 0.7).to(dev)
        for dtype in both:
            if kind == "flow":
                system = make_tortuosity_system(mask, 0, -1.0, 1.0,
                                                dtype=dtype)
            else:
                system = make_cell_problem_system(mask, 1, dtype=dtype)
            sa = SAMGPreconditioner.from_system(system)
            require(len(sa.levels) == 3, f"{case}: {len(sa.levels)} levels")
            for li, lvl in enumerate(sa.levels):
                lcase = (f"{case} level {li + 1} "
                         f"{len(lvl.offsets)} taps nn {lvl.nn}")
                check_k3(chk, lvl, gen, lcase, (dtype,))
                if dtype == torch.float32:
                    check_k3(chk, _bf16(lvl), gen, lcase, both)
            y = sa(torch.where(system.free, torch.randn(
                shape, generator=gen, dtype=dtype, device=dev), 0.0))
            require(bool(torch.isfinite(y).all()), f"{case}: cycle not finite")
    phase_kernels_restricted(chk, gen, dev)
    cases = [
        ("odd 100x98x97 iso clamped", (100, 98, 97), "flow", (1, 1, 1)),
        ("even 64x48x40 iso clamped", (64, 48, 40), "flow", (1, 1, 1)),
        ("even 64x48x40 aniso clamped", (64, 48, 40), "flow", (1, 0.5, 2)),
        ("even 50x36x30 iso periodic", (50, 36, 30), "cell", (1, 1, 1)),
        ("odd 33x20x17 aniso periodic", (33, 20, 17), "cell", (1, 0.5, 2)),
    ]
    for case, shape, kind, dx in cases:
        mask = torch.from_numpy(rng.random(shape) < 0.7).to(dev)
        for dtype in (torch.float32, torch.float64):
            if kind == "flow":
                system = make_tortuosity_system(mask, 0, -1.0, 1.0, dx=dx,
                                                dtype=dtype)
            else:
                system = make_cell_problem_system(mask, 1, dx=dx, dtype=dtype)
            x, _ = check_k1(chk, system, gen, dtype, case)
            # K4 and K5 on the system's own decoded (diag, free)
            check_restricted(chk, x, system.diag.contiguous(), system.free,
                             system.w, system.periodic, case)
            check_k2(chk, fine_conductances(system), gen, case + " fine")
            mg = GalerkinMGPreconditioner.from_system(system)
            for li, lvl in enumerate(mg.levels):
                check_k2(chk, lvl, gen, f"{case} level {li + 1}")
    phase_kernels_k1_seams(chk, gen, dev, rng)
    summary = {k: {"max_abs_err": v, "cases": len(chk.cases.get(k, []))}
               for k, v in sorted(chk.max_err.items())}
    log("kernel_checks " + json.dumps(summary))


# the perc phase: the sizes whose per-method walls are logged (the main
# size is added), and its small cases
PERC_SIZES = (128, 256)
SERPENTINE_N = 48


def _host_fill(vol, direction, method="host"):
    """``percolation_mask`` with a host ``method`` and its wall seconds
    (run in a worker thread while the card checks its kernels)."""
    from openimpala_tpu_torch.io import native
    from openimpala_tpu_torch.ops.floodfill import percolation_mask

    if method == "native":
        native.require_lib()  # its build is not the method's time
    t0 = time.perf_counter()
    mask, vf = percolation_mask(vol, 1, direction, method=method)
    return mask, vf, time.perf_counter() - t0


@contextlib.contextmanager
def _record_fills():
    """Record each call of the bit-packed fill (shape, direction, rounds)
    through a stand-in for ``packfill.percolation_oneshot_packed`` that
    changes nothing else."""
    from openimpala_tpu_torch.ops import packfill

    fills = []
    fill = packfill.percolation_oneshot_packed

    def recording(phase_ok, direction):
        out = fill(phase_ok, direction)
        fills.append({"shape": list(phase_ok.shape),
                      "direction": direction, "rounds": out[2]})
        return out

    packfill.percolation_oneshot_packed = recording
    try:
        yield fills
    finally:
        packfill.percolation_oneshot_packed = fill


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _serpentine(n):
    """The serpentine of ``tests/test_ops.py::test_raster_fill_serpentine``
    at edge ``n``: open rows in the (X, Y) plane at Z = 1, joined at
    alternate ends, so the path turns about n/2 times."""
    phase = np.zeros((n, n, 3), np.uint8)
    for i in range(n):
        phase[i, :, 1] = 1 if i % 2 == 0 else 0
        if i % 4 == 1:
            phase[i, n - 1, 1] = 1
        elif i % 4 == 3:
            phase[i, 0, 1] = 1
    return phase


def _hold_device(case, phase, d, host, fills):
    """``method="device"`` against the host's (mask, vf) bit for bit;
    returns the device call's wall seconds and rounds."""
    from openimpala_tpu_torch.ops.floodfill import percolation_mask

    mask, vf = host
    (dev, dvf), sec = _wall(lambda: percolation_mask(
        phase, 1, d, method="device", device="cuda"))
    require(dev.is_cuda and dev.dtype == torch.bool,
            f"perc[{case}]: the device fill returned {dev.device} "
            f"{dev.dtype}")
    same = torch.equal(dev, torch.from_numpy(np.asarray(mask)).to(dev.device))
    require(same and dvf == vf,
            f"perc[{case}] {'XYZ'[d]}: the device fill differs from the "
            f"host's (active_vf {dvf!r} against {vf!r})")
    return sec, fills[-1]["rounds"]


def phase_perc(vol, n, host_jobs):
    """The percolation methods on the card against the host (module
    docstring, phase 3).  ``host_jobs[d]`` is the host fill of ``vol``
    along ``d``, ``host_jobs["native"]`` the native one along X
    (``_host_fill``, running in worker threads).  Returns the host's X mask of
    ``vol`` on the card, for the main paths."""
    from openimpala_tpu_torch.ops.floodfill import (
        auto_method, percolation_mask)

    rng = np.random.default_rng(SEED)
    table = []
    with _record_fills() as fills:
        # the card's first use of the fill's ops, outside the timings
        percolation_mask(make_blobs(32, 0.4, SEED), 1, 0, method="device",
                         device="cuda")
        open_ = np.ones((64, 64, 64), np.uint8)
        empty_face = vol[:64, :64, :64].copy()
        empty_face[0] = 0
        small = [("100^3 blobs", make_blobs(100, 0.4, SEED), (0, 1, 2)),
                 ("33x40x24 random", (rng.random((33, 40, 24)) < 0.5)
                  .astype(np.uint8), (0, 1, 2)),
                 (f"serpentine {SERPENTINE_N}^2 x 3",
                  _serpentine(SERPENTINE_N), (0,)),
                 ("empty inlet face 64^3", empty_face, (0,)),
                 ("all open 64^3", open_, (0, 1, 2))]
        for case, phase, dirs in small:
            for d in dirs:
                host = percolation_mask(phase, 1, d, method="host")
                sec, rounds = _hold_device(case, phase, d, host, fills)
                log(f"perc[{case}] {'XYZ'[d]}: device = host, active_vf "
                    f"{host[1]!r}, {rounds} rounds, {sec * 1e3:.1f} ms")
                if case.startswith("empty"):
                    require(host[1] == 0.0, f"perc[{case}]: not empty")
                if case.startswith("all open"):
                    require(host[1] == 1.0, f"perc[{case}]: not all open")
        for size in PERC_SIZES + (n,):
            if size > n:
                continue
            v = vol if size == n else make_blobs(size, 0.4, SEED)
            for d in ((0, 1, 2) if size == n else (0,)):
                if size == n:
                    mask, vf, host_s = host_jobs[d].result()
                else:
                    (mask, vf), host_s = _wall(lambda: percolation_mask(
                        v, 1, d, method="host"))
                dev_s, rounds = _hold_device(f"{size}^3 blobs", v, d,
                                             (mask, vf), fills)
                row = {"n": size, "direction": "XYZ"[d], "host_ms":
                       host_s * 1e3, "device_ms": dev_s * 1e3,
                       "device_rounds": rounds, "active_vf": vf,
                       "auto": auto_method(v.shape, "cuda")}
                if d == 0 and size == n:
                    nat, nvf, nat_s = host_jobs["native"].result()
                elif d == 0:
                    (nat, nvf), nat_s = _wall(lambda: percolation_mask(
                        v, 1, d, method="native"))
                if d == 0:
                    require(np.array_equal(nat, mask) and nvf == vf,
                            f"perc[{size}^3 blobs] X: native differs from "
                            "host")
                    row["native_ms"] = nat_s * 1e3
                if size == n and d == 0:
                    mask_x = torch.from_numpy(mask).to("cuda")
                table.append(row)
                log("perc " + json.dumps(row))
    log(f"perc auto rule on cuda: " + json.dumps(
        {f"{s}^3": auto_method((s, s, s), "cuda")
         for s in (64, 128, 256, 512, 1024)}))
    return {"mask_x": mask_x, "table": table}


def _k1_routes():
    """K1's launches since the last reset, by (name, route, extent)."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    return dict(sc.launches_route_at)


def _log_counts(label, counts, at, plain, routes=None):
    log(f"main[{label}] launches " + json.dumps(counts, sort_keys=True))
    if routes:
        log(f"main[{label}] k1_routes " + json.dumps(
            {f"{k} {route} {'x'.join(map(str, shp))}": v
             for (k, route, shp), v in sorted(routes.items())}))
    if at:
        log(f"main[{label}] k2_to_k5_launches_by_extent " + json.dumps(
            {f"{k} {'x'.join(map(str, shp))}": v
             for (k, shp), v in sorted(at.items())}))
    log(f"main[{label}] plain_on_cuda " + json.dumps(plain, sort_keys=True))


def _all_counts():
    """Every launch counter (``stencil_cuda.COUNTERS``) as plain dicts."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    return {k: dict(v) for k, v in sc.snapshot_counts().items()}


def _stats():
    """A copy of the graph statistics, with the launches of the steps
    executed past the counts (``graphs.surplus_counts``)."""
    from openimpala_tpu_torch.utils import graphs

    return dict(graphs.stats, surplus_counts={
        k: collections.Counter(v) for k, v in graphs.surplus_counts.items()})


def _graph_stats(label):
    """The CUDA graphs' captures, replays and capture seconds since the
    last ``graphs.reset_stats()``, and the PCG loops' iterations counted
    (read) and executed in their Krylov calls (one per refinement round),
    logged.  Executed may pass counted by at most ``graphs.IN_FLIGHT``
    done-gated steps a call; on the graphs every executed step is the
    eager first step of a holder or a replay."""
    from openimpala_tpu_torch.utils import graphs

    st = _stats()
    w = graphs.IN_FLIGHT
    log(f"main[{label}] graph: captures={st['captures']}, "
        f"replays={st['replays']}, capture_s={st['capture_s']:.3f}; "
        f"iterations counted / executed {st['reads']} / {st['steps']} in "
        f"{st['calls']} Krylov calls (refinement rounds; IN_FLIGHT={w})")
    require(0 <= st["steps"] - st["reads"] <= w * st["calls"],
            f"main[{label}]: {st['steps']} iterations executed for "
            f"{st['reads']} counted in {st['calls']} calls (at most "
            f"{w} a call past the count)")
    require(not st["calls"]
            or st["steps"] == st["captures"] + st["replays"],
            f"main[{label}]: {st['steps']} PCG steps executed, "
            f"{st['captures']} eager + {st['replays']} replayed")
    return st


def _reset():
    """Zero the launch counters and the graph statistics."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.utils import graphs

    sc.reset_counts()
    graphs.reset_stats()


def _eager_twin(call):
    """``call()`` again with every solver step eager on the card
    (``graphs._eager_twin``), the counters zeroed just before: (its
    result, every counter, wall seconds, the graph statistics)."""
    from openimpala_tpu_torch.utils import graphs

    torch.cuda.empty_cache()
    _reset()
    with graphs._eager_twin():
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, _all_counts(), wall, _stats()


def _inner(history):
    """A result's inner residual records, as one list: (solve, iteration,
    rel_res) for each iteration of each solve (``history`` a ResidualHistory
    or a tuple of them; a lanes solve's rel_res is one per lane)."""
    hists = history if isinstance(history, tuple) else (history,)
    return [(i, it, rel) for i, h in enumerate(hists) if h is not None
            for it, rel in h.inner]


def _less_surplus(counts, gstats):
    """Launch counters less the launches of the done-gated steps the
    graphed PCG loops ran past their counts (``surplus_counts``)."""
    surplus = gstats["surplus_counts"]
    return {k: dict(+(collections.Counter(v)
                      - surplus.get(k, collections.Counter())))
            for k, v in counts.items()}


def _require_twin(label, got, want, counts, twin_counts, gstats, tstats,
                  hists=None):
    """A graphed run and its eager twin: the same result and iterations
    (``got``, ``want``: comparable keys); the twin executes exactly the
    iterations it counts, as many as the graphed run counts; every counter
    equal once the graphed run's done-gated steps past its counts are
    taken off (``gstats``, ``tstats``: the two runs' graph statistics).  On
    a difference, ``hists`` (the two runs' ``history``) are printed up to
    the first iteration where their residuals differ, with both runs' K1
    launches by route and extent, before the check fails."""
    if got != want and hists is not None:
        a, b = (_inner(h) for h in hists)
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
        log(f"main[{label}] twin mismatch: residual histories up to the "
            f"first differing iteration ({first}; solve, iteration, "
            f"rel_res):")
        log(f"main[{label}]   graphed {json.dumps(a[:first + 1])}")
        log(f"main[{label}]   eager   {json.dumps(b[:first + 1])}")
        for name, c in (("graphed", counts), ("eager", twin_counts)):
            log(f"main[{label}]   {name} k1_routes " + json.dumps(
                {f"{k} {route} {'x'.join(map(str, shp))}": v for
                 (k, route, shp), v in sorted(
                     c["launches_route_at"].items())}))
    require(got == want, f"main[{label}]: graphed {got!r} against its eager "
                         f"twin {want!r}")
    log(f"main[{label}] iterations counted / executed: graphed "
        f"{gstats['reads']} / {gstats['steps']}, eager twin "
        f"{tstats['reads']} / {tstats['steps']} ({tstats['calls']} Krylov "
        f"calls)")
    require(tstats["steps"] == tstats["reads"] == gstats["reads"]
            and tstats["calls"] == gstats["calls"],
            f"main[{label}]: the eager twin executed {tstats['steps']} "
            f"iterations and counted {tstats['reads']} in "
            f"{tstats['calls']} calls, the graphed run counted "
            f"{gstats['reads']} in "
            f"{gstats['calls']}")
    counts = _less_surplus(counts, gstats)
    twin_counts = _less_surplus(twin_counts, tstats)
    diff = {k: (counts[k], twin_counts[k]) for k in counts
            if counts[k] != twin_counts[k]}
    require(not diff, f"main[{label}]: launch counters differ between the "
                      f"graphed run (less its steps past the count) and "
                      f"its eager twin: {diff}")


def _drive_tau(label, vol, n, dx, precond, host_mask=None, opts=None,
               warm=None):
    """One ``tortuosity`` call (``opts``: its ``precond_opts``; ``warm``:
    its ``warm=`` handle), counted on its own.  Where "auto" sends the
    percolation to the card, the device fill must have run; ``host_mask``:
    the host's mask of this volume, which the run's must equal."""
    from openimpala_tpu_torch import tortuosity
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.ops.floodfill import auto_method

    timings = {}
    torch.cuda.reset_peak_memory_stats()
    _reset()
    with _record_fills() as fills:
        t0 = time.perf_counter()
        res = tortuosity(vol, 1, "X", eps=1e-9, dx=dx, precond=precond,
                         precond_opts=opts, device="cuda", timings=timings,
                         return_fields=True, return_history=True,
                         warm=warm)
        wall = time.perf_counter() - t0
    counts, plain = dict(sc.launches), dict(sc.plain_on_cuda)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    full = _all_counts()
    gstats = _graph_stats(label)
    rule = auto_method(vol.shape, "cuda")
    log(f"main[{label}] percolation: method={res.percolation_method} "
        f"(auto rule {rule}), device fills {json.dumps(fills)}")
    require(res.percolation_method == rule,
            f"main[{label}]: percolation took {res.percolation_method}, "
            f"the rule names {rule}")
    if rule == "device":
        require(len(fills) == 1 and fills[0]["direction"] == 0,
                f"main[{label}]: the device fill did not run once: {fills}")
    if host_mask is not None:
        require(torch.equal(res.active, host_mask),
                f"main[{label}]: the mask differs from the host's")
    at = dict(sc.launches_at)  # (name, extent) -> K2 to K5 launches
    routes = _k1_routes()
    log(f"main[{label}] {n}^3 dx={dx} precond={precond} opts={opts}: "
        f"tau={res.value!r} "
        f"active_vf={res.active_vf!r} iterations={res.iterations} "
        f"rel_res={res.rel_res!r} flux_rel_diff={res.flux_rel_diff!r} "
        f"converged={res.converged} flux_conserved={res.flux_conserved} "
        f"wall_s={wall:.3f} "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    log(f"main[{label}] step_s " + json.dumps(
        {k: round(v, 4) for k, v in timings.items()}))
    _log_counts(label, counts, at, plain, routes)
    require(res.converged and res.flux_conserved,
            f"main[{label}]: converged={res.converged} "
            f"flux_conserved={res.flux_conserved}")
    dots = counts.get("k1_matvec_dot_f32", 0)
    require(dots >= res.iterations,
            f"main[{label}]: K1 matvec+dot launched {dots} times for "
            f"{res.iterations} PCG iterations")
    require(gstats["captures"] >= 1 and gstats["replays"] >= 1,
            f"main[{label}]: the PCG steps were not replayed: {gstats}")
    require(gstats["reads"] == res.iterations,
            f"main[{label}]: the loops counted {gstats['reads']} "
            f"iterations, the result {res.iterations}")
    twin, twin_counts, twin_wall, tstats = _eager_twin(lambda: tortuosity(
        vol, 1, "X", eps=1e-9, dx=dx, precond=precond, precond_opts=opts,
        device="cuda", return_history=True))
    log(f"main[{label}] eager twin: tau={twin.value!r} "
        f"iterations={twin.iterations} rel_res={twin.rel_res!r} "
        f"wall_s={twin_wall:.3f} (graphed {wall:.3f})")
    _require_twin(label, (res.value, res.iterations, res.rel_res),
                  (twin.value, twin.iterations, twin.rel_res), full,
                  twin_counts, gstats, tstats, (res.history, twin.history))
    return {"iterations": res.iterations, "counts": counts, "at": at,
            "plain": plain, "tau": res.value, "mask": res.active,
            "wall_s": wall, "routes": routes, "fine": (n, n, n),
            "twin_wall_s": twin_wall, "graph": gstats,
            "active_vf": res.active_vf, "peak_mem_GB": peak_gb}


_DEFAULT_AT = {}  # edge -> (volume, the default path's tau there)


def _default_at(label, nc, dx):
    """The blobs volume of edge ``nc`` and the default path's tau on it,
    from one call made for the first path that runs at that edge."""
    from openimpala_tpu_torch import tortuosity

    if nc not in _DEFAULT_AT:
        vol = make_blobs(nc, 0.4, SEED)
        ref = tortuosity(vol, 1, "X", eps=1e-9, dx=dx, device="cuda")
        require(ref.converged, f"main[{label}]: the default path at {nc}^3 "
                               "did not converge")
        log(f"main[{label}] default path at {nc}^3: tau={ref.value!r} "
            f"iterations={ref.iterations}")
        _DEFAULT_AT[nc] = (vol, ref.value)
    return _DEFAULT_AT[nc]


def _drive_cheby(label, vol, n, dx, precond, runs):
    """``tortuosity(precond="cheby")`` on a CHEBY_N^3 volume; its tau is held
    against the default path's on the same volume (``main[iso]``'s, or a
    default-path call at CHEBY_N where that differs from n)."""
    nc = min(n, CHEBY_N)
    if nc == n:
        ref_tau = runs["iso"]["tau"]
    else:
        vol, ref_tau = _default_at(label, nc, dx)
    run = _drive_tau(label, vol, nc, dx, precond)
    rel = abs(run["tau"] - ref_tau) / abs(ref_tau)
    log(f"main[{label}] tau against the default path: rel {rel:.3e}")
    require(rel <= 1e-6,
            f"main[{label}]: tau differs from the default path by {rel:.3e}")
    c = run["counts"]
    k4 = {k: v for k, v in c.items() if k.startswith("k4_")}
    require(not k4, f"main[{label}]: the preconditioner launched K4: {k4}")
    # one application per executed iteration (the matvec+dot count), each
    # degree - 1 operator applications
    want = (CHEBY_DEGREE - 1) * c.get("k1_matvec_dot_f32", 0)
    require(c.get("k5_matvec_f32", 0) == want,
            f"main[{label}]: K5 launched {c.get('k5_matvec_f32', 0)} times, "
            f"{want} expected for {CHEBY_DEGREE - 1} per application")
    return run


def _mg_extents(n):
    """The extents of ``precond="mg"``'s hierarchy on an n^3 volume, fine
    to coarse (``MultigridPreconditioner.from_system``'s rule)."""
    from openimpala_tpu_torch.solve.preconditioners import _can_coarsen

    shapes = [(n, n, n)]
    while len(shapes) < 10 and _can_coarsen(shapes[-1]):
        shapes.append(tuple(s // 2 for s in shapes[-1]))
    return shapes


def _drive_mg(label, vol, n, dx, precond, host_mask, opts):
    """``tortuosity(precond="mg")``: K1 must launch at every extent of the
    hierarchy, K2 never."""
    run = _drive_tau(label, vol, n, dx, precond, host_mask, opts)
    extents = _mg_extents(n)
    seen = {k[2] for k in run["routes"]}
    missing = [e for e in extents if e not in seen]
    require(not missing, f"main[{label}]: no K1 launch at the extents "
                         f"{missing} of the hierarchy {extents}")
    stray = sorted(seen - set(extents))
    require(not stray, f"main[{label}]: K1 ran at extents of no level: "
                       f"{stray}")
    k2 = {k: v for k, v in run["counts"].items() if k.startswith("k2_")}
    require(not k2, f"main[{label}]: the rediscretised cycle launched K2: "
                    f"{k2}")
    run["extents"] = extents
    return run


def _drive_option(label, vol, n, dx, precond, host_mask, opts):
    """The default cycle with one option, on an OPTION_N^3 volume where n
    is larger, its tau held against the default path's there.  The
    Chebyshev smoother applies the operators: no K1 sweep at the fine
    extent and no K2 sweep."""
    nc = min(n, OPTION_N)
    if nc == n:
        run = _drive_tau(label, vol, n, dx, precond, host_mask, opts)
    else:
        vol, ref_tau = _default_at(label, nc, dx)
        run = _drive_tau(label, vol, nc, dx, precond, None, opts)
        rel = abs(run["tau"] - ref_tau) / abs(ref_tau)
        log(f"main[{label}] tau against the default path at {nc}^3: rel "
            f"{rel:.3e}")
        require(rel <= 1e-6, f"main[{label}]: tau differs from the default "
                             f"path by {rel:.3e}")
    if opts.get("smoother") == "cheby":
        sweeps = {k: v for k, v in run["routes"].items()
                  if k[0].startswith("k1_sweep") and k[2] == run["fine"]}
        k2 = {k: v for k, v in run["counts"].items()
              if k.startswith("k2_sweep")}
        require(not sweeps and not k2,
                f"main[{label}]: the Chebyshev smoother swept: {sweeps} {k2}")
    return run


@contextlib.contextmanager
def _record_fgmres():
    """Record each FGMRES solve of ``solve_system`` (restart depth, Arnoldi
    steps per cycle, device memory at its start and its peak) through a
    stand-in for ``refine.fgmres`` that changes nothing else.  The peak
    statistics restart at each solve; ``peaks`` keeps the peak reached
    before each restart."""
    import openimpala_tpu_torch.solve.refine as pr

    calls, peaks = [], []
    solve = pr.fgmres

    def recording(system, r0, *a, **kw):
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = solve(system, r0, *a, **kw)
        torch.cuda.synchronize()
        calls.append({"restart": res.restart, "cycle_steps":
                      list(res.cycle_steps), "iterations": res.iterations,
                      "rel_res": res.rel_res, "base_bytes": base,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "field_bytes": r0.numel() * r0.element_size()})
        return res

    pr.fgmres = recording
    try:
        yield calls, peaks
    finally:
        pr.fgmres = solve


_RAW = {}  # "dir": where the main volume's RAW file lives; "path": it


def _main_raw(vol) -> str:
    """The main volume as a uint8 RAW file (X fastest), written once and
    read by the CLI path and the sharded phase; ``main`` removes it."""
    import os

    if "path" not in _RAW:
        path = os.path.join(_RAW["dir"], "vol_uint8.raw")
        np.ascontiguousarray(vol.T, dtype=np.uint8).tofile(path)
        _RAW["path"] = path
    return _RAW["path"]


def _drive_cli(label, vol, n):
    """The port's CLI in-process on a uint8 RAW file of ``vol``
    (flow_through, X, solver_type = GMRES: FGMRES with the default cycle).
    ``results.txt`` is parsed back: its VolumeFraction line must be the
    port's ``volume_fraction`` and its tau that of the run.  Logs the
    restart depth, the Arnoldi steps, the peak memory and the fields the
    solve held beside its Krylov basis."""
    import os
    import tempfile

    from openimpala_tpu_torch import diffusion
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.props.volume_fraction import volume_fraction

    results, handles = [], []
    tau_fn, prime_fn = diffusion.tortuosity, diffusion.prime_solver

    def recording(*a, **kw):
        results.append(tau_fn(*a, **kw))
        return results[-1]

    def recording_prime(*a, **kw):  # the early warm-up's handle
        handles.append(prime_fn(*a, **kw))
        return handles[-1]

    raw = _main_raw(vol)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "run.inputs")
        with open(inputs, "w") as f:
            f.write(f"filename = {os.path.basename(raw)}\n"
                    f"data_path = {os.path.dirname(raw)}/\n"
                    f"results_path = {tmp}/results/\n"
                    f"raw.width = {vol.shape[0]}\nraw.height = {vol.shape[1]}"
                    f"\nraw.depth = {vol.shape[2]}\nraw.datatype = UINT8\n"
                    "phase_id = 1\ncalculation_method = flow_through\n"
                    "direction = X\nsolver_type = GMRES\nhypre.eps = 1e-9\n"
                    "verbose = 1\n")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset()
        diffusion.tortuosity = recording
        diffusion.prime_solver = recording_prime
        try:
            with _record_fgmres() as (calls, peaks):
                t0 = time.perf_counter()
                rc = diffusion.main([inputs])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            diffusion.tortuosity = tau_fn
            diffusion.prime_solver = prime_fn
        counts, plain = dict(sc.launches), dict(sc.plain_on_cuda)
        routes = _k1_routes()
        peak = max(peaks + [torch.cuda.max_memory_allocated()])
        with open(os.path.join(tmp, "results", "results.txt")) as f:
            lines = f.read().splitlines()
        # the kernels were built and loaded at the script's start (phase
        # card, through the same warm-up): no thread starts
        require(len(handles) == 1 and handles[0] is None,
                f"main[{label}]: the CLI's early warm-up started a thread "
                f"for kernels loaded already: {handles}")
        log(f"main[{label}] early warm-up (at reader-metadata time): none "
            "started, the solve's kernels are loaded in this process")
    require(rc == 0 and len(results) == 1 and calls,
            f"main[{label}]: the CLI returned {rc} after {len(results)} "
            f"tortuosity calls and {len(calls)} FGMRES solves")
    res = results[0]
    gstats = _graph_stats(label)
    require(gstats["captures"] == 0,
            f"main[{label}]: FGMRES captured a graph: {gstats}")
    vals = dict(line.split(": ", 1) for line in lines
                if ": " in line and not line.startswith("#"))
    vf = volume_fraction(vol, 1, device="cuda")
    require(vals.get("VolumeFraction") == f"{vf:.9f}",
            f"main[{label}]: results.txt VolumeFraction "
            f"{vals.get('VolumeFraction')!r}, volume_fraction {vf!r}")
    tau_txt = float(vals["Tortuosity_X"])
    require(tau_txt == float(f"{res.value:.9f}"),
            f"main[{label}]: results.txt tau {tau_txt!r}, the run's "
            f"{res.value!r}")
    steps = sum(c["iterations"] for c in calls)
    field = calls[0]["field_bytes"]
    # what a solve held beyond its start and its Krylov basis (k + 1 basis
    # and k preconditioned fields after k steps), in fields: the
    # WORK_FIELDS that solve/fgmres.py budgets beside the basis
    beside = max((c["peak_bytes"] - c["base_bytes"]) / c["field_bytes"]
                 - (2 * max(c["cycle_steps"]) + 1) for c in calls)
    log(f"main[{label}] {n}^3 CLI flow_through X solver_type=GMRES: "
        f"tau={res.value!r} results.txt {vals!r} active_vf="
        f"{res.active_vf!r} iterations={res.iterations} "
        f"rel_res={res.rel_res!r} converged={res.converged} "
        f"flux_conserved={res.flux_conserved} wall_s={wall:.3f} "
        f"peak_mem_GB={peak / 1e9:.2f}")
    log(f"main[{label}] fgmres restart m={calls[0]['restart']} "
        f"Arnoldi steps={steps} per solve "
        + json.dumps([{k: v for k, v in c.items() if k != "field_bytes"}
                      for c in calls])
        + f"; fields beside the basis {beside:.2f} "
        f"(field {field / 1e9:.3f} GB)")
    _log_counts(label, counts, {}, plain, routes)
    require(res.converged and res.flux_conserved,
            f"main[{label}]: converged={res.converged} "
            f"flux_conserved={res.flux_conserved}")
    require(res.iterations == steps,
            f"main[{label}]: {res.iterations} iterations, {steps} Arnoldi "
            "steps")
    mv = counts.get("k1_matvec_f32", 0)
    require(mv >= steps, f"main[{label}]: K1 matvec launched {mv} times for "
                         f"{steps} Arnoldi steps")
    return {"iterations": steps, "counts": counts, "at": {}, "plain": plain,
            "tau": res.value, "wall_s": wall, "routes": routes,
            "fine": (n, n, n), "fgmres": calls, "peak_bytes": peak,
            "beside_fields": beside}


def _drive_deff(label, vol, n, dx, precond):
    """One ``effective_diffusivity`` call on the whole volume under
    ``lanes="auto"``, which must take the path the card's rule names
    (``lanes_pay``, then the memory gate ``use_lanes``); then the same call
    forced onto the other path, whose tensor and iterations must agree (not
    counted)."""
    from openimpala_tpu_torch import effective_diffusivity
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.solve.lanes import lanes_pay, use_lanes

    timings = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset()
    t0 = time.perf_counter()
    res = effective_diffusivity(vol, 1, eps=1e-9, dx=dx, precond=precond,
                                device="cuda", timings=timings,
                                return_history=True)
    wall = time.perf_counter() - t0
    counts, plain = dict(sc.launches), dict(sc.plain_on_cuda)
    full = _all_counts()
    gstats = _graph_stats(label)
    peak = torch.cuda.max_memory_allocated()
    routes = _k1_routes()
    pays = lanes_pay(vol.size, "cuda")
    admits = use_lanes(vol.size, 3, "cg", device="cuda")
    log(f"main[{label}] {n}^3 dx={dx} precond={precond}: "
        f"deff={res.deff.tolist()!r} volume_fraction={res.volume_fraction!r} "
        f"iterations={res.iterations} rel_res={res.rel_res!r} "
        f"converged={res.converged} wall_s={wall:.3f} "
        f"peak_mem_GB={peak / 1e9:.2f} lanes={res.lanes} (for {vol.size} "
        f"cells the lanes pay on the card: {pays}; use_lanes admits them: "
        f"{admits})")
    require(res.lanes == (pays and admits),
            f"main[{label}]: lanes ran {res.lanes}, the card's rule says "
            f"{pays and admits}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    twin = effective_diffusivity(vol, 1, eps=1e-9, dx=dx, precond=precond,
                                 device="cuda", lanes=not res.lanes)
    twin_wall = time.perf_counter() - t0
    err = float(np.abs(twin.deff - res.deff).max())
    log(f"main[{label}] twin lanes={not res.lanes}: "
        f"iterations={twin.iterations} wall_s={twin_wall:.3f} "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f}; "
        f"max abs diff of the tensors {err:.3e}")
    require(twin.converged and err <= 1e-9,
            f"main[{label}]: lanes and sequential tensors differ by "
            f"{err:.3e}")
    require(all(abs(a - b) <= 1 for a, b in zip(res.iterations,
                                                twin.iterations)),
            f"main[{label}]: iterations {res.iterations} against "
            f"{twin.iterations}")
    log(f"main[{label}] step_s " + json.dumps(
        {k: round(v, 4) for k, v in timings.items()}))
    _log_counts(label, counts, {}, plain, routes)
    require(res.converged and max(res.rel_res) <= 1e-9,
            f"main[{label}]: converged={res.converged} rel_res={res.rel_res}")
    require(res.deff.shape == (3, 3) and bool(np.isfinite(res.deff).all()),
            f"main[{label}]: deff not a finite 3x3 tensor")
    asym = float(np.abs(res.deff - res.deff.T).max())
    require(asym <= 1e-9, f"main[{label}]: deff asymmetric by {asym:.3e}")
    vf = float((vol == 1).sum()) / vol.size
    require(res.volume_fraction == vf,
            f"main[{label}]: volume_fraction {res.volume_fraction!r} != "
            f"{vf!r}")
    its = sum(res.iterations)
    dots = counts.get("k1_matvec_dot_f32", 0)
    require(dots >= its, f"main[{label}]: K1 matvec+dot launched {dots} "
                         f"times for {its} PCG iterations")
    require(gstats["captures"] >= 1 and gstats["replays"] >= 1,
            f"main[{label}]: the PCG steps were not replayed: {gstats}")
    require(res.lanes or gstats["reads"] == its,
            f"main[{label}]: the loops counted {gstats['reads']} "
            f"iterations, the result {its}")
    eager, eager_counts, eager_wall, tstats = _eager_twin(
        lambda: effective_diffusivity(vol, 1, eps=1e-9, dx=dx,
                                      precond=precond, device="cuda",
                                      lanes=res.lanes, return_history=True))
    log(f"main[{label}] eager twin: lanes={eager.lanes} "
        f"D_xx={eager.deff[0, 0]!r} iterations={eager.iterations} "
        f"wall_s={eager_wall:.3f} (graphed {wall:.3f})")
    _require_twin(label, (res.deff.tolist(), res.iterations, res.rel_res),
                  (eager.deff.tolist(), eager.iterations, eager.rel_res),
                  full, eager_counts, gstats, tstats,
                  (res.history, eager.history))
    return {"iterations": its, "counts": counts, "at": {}, "plain": plain,
            "wall_s": wall, "routes": routes, "fine": (n, n, n),
            "value": float(res.deff[0, 0]), "twin_wall_s": eager_wall,
            "graph": gstats, "deff": res.deff, "per_direction":
            tuple(res.iterations), "peak_mem_GB": peak / 1e9}


def _drive_rev(label, vol, n, dx):
    """One ``rev_study`` call: REV_SAMPLES crops of REV_SIZE^3, one batched
    group.  The iterations each direction executed are read from the launch
    counters at the direction's two ends, through a recording stand-in for
    ``batched_cell_problems`` that changes nothing else."""
    import openimpala_tpu_torch.solve.batched as pb
    from openimpala_tpu_torch import effective_diffusivity, rev_study
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.props.rev import (_resolve_batch,
                                                auto_batch_max_cells)

    size = min(REV_SIZE, n)
    choice = _resolve_batch("auto", (size,) * 3, REV_SAMPLES, {},
                            device="cuda")
    table = size ** 3 <= auto_batch_max_cells("cuda")
    log(f"main[{label}] batch=\"auto\" for {REV_SAMPLES} crops of {size}^3 "
        f"on the card: batched={choice} (the card's table: batched up to "
        f"{auto_batch_max_cells('cuda')} cells a crop)")
    require(choice == table and choice,
            f"main[{label}]: batch=\"auto\" chose {choice}, the table says "
            f"{table}")
    per_dir = []
    solve = pb.batched_cell_problems

    def recording(masks, k, *a, **kw):
        torch.cuda.synchronize()
        before, t0 = dict(sc.launches), time.perf_counter()
        out = solve(masks, k, *a, **kw)
        torch.cuda.synchronize()
        d = {name: sc.launches[name] - before.get(name, 0) for name in _K4}
        per_dir.append({"direction": k, "lanes": int(masks.shape[0]),
                        "seconds": time.perf_counter() - t0,
                        "executed_iterations": d["k4_matvec_dot_f32"], **d})
        return out

    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _reset()
    pb.batched_cell_problems = recording
    t0 = time.perf_counter()
    try:
        samples = rev_study(vol, 1, sizes=(size,), num_samples=REV_SAMPLES,
                            eps=1e-9, dx=dx, device="cuda")
    finally:
        pb.batched_cell_problems = solve
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(sc.launches), dict(sc.plain_on_cuda)
    full = _all_counts()
    gstats = _graph_stats(label)
    peak = torch.cuda.max_memory_allocated() - base_mem
    crop_bytes = size ** 3 * 4
    n_conv = sum(s.converged for s in samples)
    log(f"main[{label}] {REV_SAMPLES} crops of {size}^3 x 3 directions: "
        f"converged={n_conv}/{len(samples)} wall_s={wall:.3f} "
        f"peak_mem_GB={peak / 1e9:.3f} "
        f"bytes_per_crop={peak / REV_SAMPLES:.0f} "
        f"f32_fields_per_crop={peak / REV_SAMPLES / crop_bytes:.2f} "
        f"D_xx mean={float(np.mean([s.deff[0, 0] for s in samples]))!r}")
    log(f"main[{label}] per_direction " + json.dumps(per_dir))
    _log_counts(label, counts, {}, plain)
    require(len(samples) == REV_SAMPLES and n_conv == REV_SAMPLES,
            f"main[{label}]: {n_conv} of {len(samples)} crops converged, "
            f"{REV_SAMPLES} expected")
    require(len(per_dir) == 3 and all(d["lanes"] == REV_SAMPLES
                                      for d in per_dir),
            f"main[{label}]: not one batched group of {REV_SAMPLES} lanes "
            f"in three directions: {per_dir}")
    for d in per_dir:
        # the polynomial: degree - 1 operator applications each time it is
        # applied, once per executed iteration and once at the start of
        # every inner round
        extra = d["k4_matvec_f32"] - (CHEBY_DEGREE_BATCHED - 1) * d[
            "executed_iterations"]
        require(d["executed_iterations"] > 0 and extra > 0
                and extra % (CHEBY_DEGREE_BATCHED - 1) == 0,
                f"main[{label}]: direction {d['direction']}: K4 launches "
                f"{d} do not fit {CHEBY_DEGREE_BATCHED - 1} per application")
        require(d["k4_matvec_f64"] >= 2,
                f"main[{label}]: direction {d['direction']}: no float64 "
                "outer residual through K4")
    bad = [s.sample_no for s in samples
           if not np.isfinite(s.deff).all()
           or np.abs(s.deff - s.deff.T).max() > 1e-8]
    require(not bad, f"main[{label}]: tensors not finite and symmetric: {bad}")
    # the batched against the sequential solver on the first crop
    s0 = samples[0]
    lo, ext = s0.seed, s0.actual_size
    crop = vol[lo[0]:lo[0] + ext[0], lo[1]:lo[1] + ext[1],
               lo[2]:lo[2] + ext[2]]
    seq = effective_diffusivity(crop, 1, eps=1e-9, dx=dx, device="cuda")
    err = float(np.abs(seq.deff - s0.deff).max())
    log(f"main[{label}] crop 1 batched against effective_diffusivity: "
        f"max abs diff {err:.3e} (sequential iterations {seq.iterations})")
    require(seq.converged and err <= 1e-6,
            f"main[{label}]: batched and sequential D_eff differ by {err:.3e}")
    require(gstats["captures"] == 3 and gstats["replays"] >= 3,
            f"main[{label}]: not one graph per direction, replayed: "
            f"{gstats}")
    mean = float(np.mean([s.deff[0, 0] for s in samples]))
    twin, twin_counts, twin_wall, tstats = _eager_twin(lambda: rev_study(
        vol, 1, sizes=(size,), num_samples=REV_SAMPLES, eps=1e-9, dx=dx,
        device="cuda"))
    twin_mean = float(np.mean([s.deff[0, 0] for s in twin]))
    log(f"main[{label}] eager twin: D_xx mean={twin_mean!r} "
        f"wall_s={twin_wall:.3f} (graphed {wall:.3f})")
    _require_twin(label, [s.deff.tolist() for s in samples],
                  [s.deff.tolist() for s in twin], full, twin_counts,
                  gstats, tstats)
    return {"iterations": sum(d["executed_iterations"] for d in per_dir),
            "counts": counts, "at": {}, "plain": plain, "wall_s": wall,
            "samples": samples, "size": size, "value": mean,
            "twin_wall_s": twin_wall, "graph": gstats}


def _require_stream_route(label, run):
    """Where the rule sends the path's fine extent to the stream route,
    every K1 launch at that extent must have taken it."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    fine = run.get("fine")
    if fine is None or sc.k1_route(fine, torch.float32) != "stream":
        return
    at_fine = {k: v for k, v in run["routes"].items() if k[2] == fine}
    require(at_fine, f"main[{label}]: no K1 launch at {fine}")
    stray = {k: v for k, v in at_fine.items() if k[1] != "stream"}
    require(not stray, f"main[{label}]: K1 launches at the fine extent off "
                       f"the stream route: {stray}")


def _drive_direct(label):
    """``tortuosity_direct`` on a DIRECT_N^3 blobs volume (porosity 0.6):
    each check of 100 steps and the measuring one replay one CUDA graph.
    Held against the JAX package's value (DIRECT_JAX); then the first
    DIRECT_TWIN_CHECKS checks of the same call graphed against its eager
    twin, bit for bit."""
    from openimpala_tpu_torch import tortuosity_direct

    vol = make_blobs(DIRECT_N, 0.6, SEED)
    call = lambda: tortuosity_direct(vol, 1, "X", eps=1e-6)  # noqa: E731
    _reset()
    t0 = time.perf_counter()
    res = call()
    wall = time.perf_counter() - t0
    full = _all_counts()
    gstats = _graph_stats(label)
    want = DIRECT_JAX
    rel = abs(res.value - want["value"]) / abs(want["value"])
    log(f"main[{label}] {DIRECT_N}^3 blobs 0.6 X eps=1e-6: "
        f"tau={res.value!r} steps={res.iterations} "
        f"residual={res.residual!r} flux_in={res.flux_in!r} "
        f"flux_out={res.flux_out!r} converged={res.converged} "
        f"wall_s={wall:.3f} steps_per_s={res.iterations / wall:.0f}; JAX "
        f"package tau={want['value']!r} steps={want['iterations']}: rel "
        f"{rel:.3e}")
    require(res.converged and rel <= 1e-6,
            f"main[{label}]: tau {res.value!r} against the JAX package's "
            f"{want['value']!r} (rel {rel:.3e})")
    require(abs(res.iterations - want["iterations"]) <= DIRECT_CHECK,
            f"main[{label}]: {res.iterations} steps against the JAX "
            f"package's {want['iterations']}")
    require(gstats["captures"] == 1
            and gstats["replays"] == res.iterations // DIRECT_CHECK - 1,
            f"main[{label}]: not one replay per check after the first: "
            f"{gstats}")
    steps = DIRECT_TWIN_CHECKS * DIRECT_CHECK
    cut = lambda: tortuosity_direct(  # noqa: E731
        vol, 1, "X", eps=1e-6, n_steps=steps, return_fields=True)
    _reset()
    t0 = time.perf_counter()
    part = cut()
    part_wall = time.perf_counter() - t0
    part_counts, part_stats = _all_counts(), _stats()
    twin, twin_counts, twin_wall, tstats = _eager_twin(cut)
    log(f"main[{label}] the first {steps} steps: graphed residual="
        f"{part.residual!r} wall_s={part_wall:.3f}; eager twin residual="
        f"{twin.residual!r} wall_s={twin_wall:.3f} "
        f"steps_per_s={twin.iterations / twin_wall:.0f}; fields equal: "
        f"{torch.equal(part.phi, twin.phi)}")
    _require_twin(label, (part.iterations, part.residual, part.flux_in,
                          part.flux_out, part.converged),
                  (twin.iterations, twin.residual, twin.flux_in,
                   twin.flux_out, twin.converged), part_counts, twin_counts,
                  part_stats, tstats)
    require(torch.equal(part.phi, twin.phi),
            f"main[{label}]: the fields differ from the eager twin's")
    return {"iterations": res.iterations, "value": res.value,
            "wall_s": wall, "twin_wall_s": twin_wall,
            "twin_steps": steps, "graph": gstats}


def _log_record(label, run, edge):
    """This run's result and iterations beside EAGER_RECORD's, where the
    run's volume (of edge ``edge``) is the one the record was taken on."""
    if label not in EAGER_RECORD or edge != EAGER_RECORD[label][2]:
        return
    value = run.get("tau", run.get("value"))
    want, its, _ = EAGER_RECORD[label]
    log(f"main[{label}] against the eager record: value {value!r} / "
        f"{want!r} "
        f"(equal: {value == want}), iterations {run['iterations']} / "
        f"{its}; wall_s graphed {run['wall_s']:.3f}, eager twin "
        f"{run.get('twin_wall_s', float('nan')):.3f}")


def _prime_iso(vol, dx, precond):
    """``prime_solver`` with the JAX CLI's keywords
    (``openimpala_tpu/diffusion.py``'s call) and ``mesh="auto"``: its
    handle, None here, since the warm-up thread of the card phase loaded
    every kernel."""
    from openimpala_tpu_torch.props.tortuosity import prime_solver

    handle = prime_solver(vol.shape, "X", vlo=-1.0, vhi=1.0, method="cg",
                          precond=precond, inner_dtype=torch.float32,
                          eps=1e-9, dx=dx, extra_dirs=(), mesh="auto")
    log(f"main[iso] prime_solver(..., mesh='auto'): handle {handle!r}")
    require(handle is None, "main[iso]: prime_solver started a warm-up "
                            "thread though every kernel is loaded")
    return handle


def phase_main(vol, n, host_mask):
    """Drive each main path on its own: the counts are zeroed just before
    its call and read just after.  ``host_mask``: the host's X mask of
    ``vol`` (the ``perc`` phase's)."""
    runs = {}
    for label, (kind, dx, precond, opts, expect) in PATHS.items():
        if label == "cheby":
            run = _drive_cheby(label, vol, n, dx, precond, runs)
        elif label == "mg":
            run = _drive_mg(label, vol, n, dx, precond, host_mask, opts)
        elif opts:
            run = _drive_option(label, vol, n, dx, precond, host_mask, opts)
        elif kind == "cli":
            run = _drive_cli(label, vol, n)
        elif kind == "tau" and label == "iso":
            run = _drive_tau(label, vol, n, dx, precond, host_mask,
                             warm=_prime_iso(vol, dx, precond))
        elif kind == "tau":
            run = _drive_tau(label, vol, n, dx, precond, host_mask)
        elif kind == "deff":
            run = _drive_deff(label, vol, n, dx, precond)
        else:
            run = _drive_rev(label, vol, n, dx)
        missing = [k for k in expect if run["counts"].get(k, 0) == 0]
        require(not missing, f"main[{label}]: never launched: {missing}")
        if "k2_cheby_f32" in expect and run["at"]:
            _require_fused_coarse(label, run["at"])
        require(not run["plain"], f"main[{label}]: plain versions ran on "
                                  f"CUDA tensors: {run['plain']}")
        _require_stream_route(label, run)
        edge = run.get("fine", (n,))[0]  # rev: crops of the main volume
        _log_record(label, run, edge)
        if label != "iso" and edge == n:
            run.pop("mask", None)  # the times phase rebuilds from iso's
        runs[label] = run
        if label in AGREE_WITH_ISO and edge == n:
            rel = abs(run["tau"] - runs["iso"]["tau"]) / abs(
                runs["iso"]["tau"])
            log(f"main[{label}] tau against main[iso]: rel {rel:.3e}; "
                f"iterations {run['iterations']} against "
                f"{runs['iso']['iterations']}; wall_s {run['wall_s']:.3f} "
                f"against {runs['iso']['wall_s']:.3f}")
            require(rel <= 1e-6, f"main[{label}]: tau differs from "
                                 f"main[iso] by {rel:.3e}")
    runs["direct"] = _drive_direct("direct")
    return runs


def _require_fused_coarse(label, at):
    """The coarsest level's Chebyshev solves ran as K2 cheby steps: per
    zero-start step, ``coarse_sweeps - 1`` cheby launches at the coarsest
    extent (the smallest that ran cheby_init), and no K2 matvec there."""
    from openimpala_tpu_torch.solve.preconditioners import (
        GalerkinMGPreconditioner)

    inits = {e: v for (k, e), v in at.items() if k == "k2_cheby_init_f32"}
    coarsest = min(inits, key=lambda e: int(np.prod(e)))
    kw = {}
    GalerkinMGPreconditioner._coarse_defaults(kw, coarsest)
    steps = at.get(("k2_cheby_f32", coarsest), 0)
    want = (kw["coarse_sweeps"] - 1) * inits[coarsest]
    matvecs = at.get(("k2_matvec_f32", coarsest), 0)
    log(f"main[{label}] coarsest {coarsest}: {inits[coarsest]} solves, "
        f"{steps} K2 cheby steps, {matvecs} K2 matvecs")
    require(steps == want and not matvecs,
            f"main[{label}]: at the coarsest extent {coarsest} {steps} K2 "
            f"cheby steps for {want}, {matvecs} K2 matvecs")


SHARDED_RANKS = 4
SHARDED_TIMEOUT = 900.0  # seconds for the whole world, start-up included
# the two smaller volumes of the sharded phase: slabs of 25 planes (odd),
# and an X extent that the ranks do not divide (254 -> 256)
SHARDED_SMALL = {"odd100": (100, 100), "padded": (256, 254)}
# what every rank must launch on the 512^3 solve
SHARDED_KERNELS = ("k1_matvec_dot_f32", "k1_sweep_f32", "k1_restrict_f32",
                   "k1_matvec_f64", "k2_matvec_f32", "k2_sweep_f32",
                   "k2_cheby_f32")
_TAU_KEYS = ("value", "active_vf", "iterations", "rel_res", "flux_in",
             "flux_out", "flux_rel_diff", "converged", "flux_conserved",
             "percolation_method")


def _small_volume(name):
    edge, x = SHARDED_SMALL[name]
    return make_blobs(edge, 0.4, SEED)[:x]


def _rank_tau(call, mesh, keys=_TAU_KEYS):
    """``call()`` on this rank with the launch counters, the mesh's
    statistics and the peak memory zeroed just before and read just
    after; ``keys``: the result's fields to return."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.parallel import mesh as pm

    torch.cuda.reset_peak_memory_stats(mesh.device)
    sc.reset_counts()
    pm.reset_stats()
    mesh.barrier()
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize(mesh.device)
    wall = time.perf_counter() - t0
    out = {k: getattr(res, k) for k in keys}
    peak = torch.cuda.max_memory_allocated(mesh.device)
    k1_at = collections.Counter()  # K1's launches by extent, every route
    for (name, _, shape), v in sc.launches_route_at.items():
        k1_at[shape] += v
    out.update(wall_s=wall, counts=dict(sc.launches),
               plain=dict(sc.plain_on_cuda), comm=dict(pm.stats),
               peak_mem_GB=peak / 1e9, at=dict(sc.launches_at),
               k1_at=dict(k1_at))
    return res, out


def _slab_kernel_checks(mesh, system, label):
    """K1 and K2 against their plain forms on this rank's slab of
    ``system`` (float32: the flow-through system, or a periodic cell
    problem, whose ghosts carry the X wrap across the seam between the
    last rank and rank 0), in the layouts the sharded cycle gives them:
    K1, every mode and the fused dot, on the ghost-padded slab (ghost
    planes from the neighbours, ``restrict`` pairing the padded slab's
    planes); K2, both modes, on each sharded coarse level of the default
    cycle, the slab padded by one plane (``SlabConductanceLevel.padded``:
    the seam conductance on the lower ghost plane, rank 0's the wrap's
    where X is periodic, the X roll wrapping)."""
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.solve.refine import make_precond
    from openimpala_tpu_torch.solve.slab_mg import SlabConductanceLevel

    dev = mesh.device
    code, w = system.code_halo, system.w
    per = st.slab_periodic(system.periodic)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10 + mesh.rank)
    shape = tuple(system.code.shape)
    x = torch.randn(shape, generator=gen, device=dev)
    r = torch.randn(shape, generator=gen, device=dev)
    xp = st.pad_slab(x, mesh, bool(system.periodic[0]))
    rp = st.pad_slab(r, ghosts=False)
    del x, r
    chk = Checker()
    case = f"rank {mesh.rank} {label} slab " + "x".join(map(str, xp.shape))
    got, dot = sc.k1_stencil("matvec", xp, None, code, w, per, with_dot=True)
    want, wdot = st.apply_code_with_dot_plain(xp, code, w, per)
    chk.close("k1_matvec_dot_f32", got, want, torch.float32, case)
    chk.dot("k1_matvec_dot_f32", dot, wdot, torch.float32, case)
    del got, want
    plain = {"matvec": lambda: st.apply_code_plain(xp, code, w, per),
             "sweep": lambda: st.smooth_sweep_plain(xp, rp, code, w, per,
                                                    0.9),
             "resid": lambda: st.residual_restricted_plain(xp, rp, code, w,
                                                           per),
             "restrict": lambda: st.residual_restrict_plain(xp, rp, code, w,
                                                            per)}
    for mode, fn in plain.items():
        got = sc.k1_stencil(mode, xp, None if mode == "matvec" else rp,
                            code, w, per, omega=0.9)
        chk.close(f"k1_{mode}_f32", got, fn(), torch.float32, case)
    out = {"shape": tuple(xp.shape),
           "route": sc.k1_route(tuple(xp.shape), torch.float32, per)}
    del xp, rp, got
    levels = [lvl.padded for lvl in make_precond(system, "auto").levels
              if isinstance(lvl, SlabConductanceLevel)]
    require(levels, f"rank {mesh.rank}: the cycle has no sharded coarse "
                    "level to hold K2 on")
    for lvl in levels:
        check_k2(chk, lvl, gen, f"rank {mesh.rank} {label} coarse slab "
                 + "x".join(map(str, lvl.diag.shape)))
    out.update(max_err=chk.max_err,
               k2_shapes=[tuple(lvl.diag.shape) for lvl in levels])
    return out


def _slab_k3_k5_checks(mesh, system, label):
    """K3 and K5 against their plain forms on this rank's padded slab of
    ``system`` (float32; clamped, or periodic with the wrap across the seam
    between the last rank and rank 0): K3, every mode and the prefix
    apply, on each sharded level of the smoothed-aggregation hierarchy
    that ``make_precond`` builds on the slab (the build timed, its
    exchanges, gathers and maxima counted), the level's coefficients in
    the slab layout and ``x`` padded by R = 2 planes from the neighbours
    (``SlabOffsetLevel.padded``, ``halo_exchange_x``); K5 on the slab
    padded by one plane, as ``ChebyshevPreconditioner`` applies it.  The
    slab forms (what the cycles call) must keep the slab's planes of the
    same outputs.  Returns the errors, the build's record and the extents
    each sharded level launches K3 at."""
    from openimpala_tpu_torch.ops import offset as po
    from openimpala_tpu_torch.ops import offset_cuda as oc
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.parallel import mesh as pm
    from openimpala_tpu_torch.parallel.halo import halo_exchange_x, pad_x
    from openimpala_tpu_torch.solve.preconditioners import (
        ChebyshevPreconditioner)
    from openimpala_tpu_torch.solve.refine import make_precond
    from openimpala_tpu_torch.solve.slab_sa import SlabOffsetLevel

    dev = mesh.device
    pm.reset_stats()
    mesh.barrier()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    M = make_precond(system, "sa")
    torch.cuda.synchronize(dev)
    build = {"s": time.perf_counter() - t0, "comm": dict(pm.stats),
             "gather": M.gather,
             "taps": [len(l.offsets) for l in M.levels
                      if isinstance(l, SlabOffsetLevel)]
             + [len(l.offsets) for l in M.glob.levels if l is not None]}
    chk = Checker()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20 + mesh.rank)
    levels = [l for l in M.levels if isinstance(l, SlabOffsetLevel)]
    require(levels, f"rank {mesh.rank} {label}: the SA cycle has no "
                    "sharded level to hold K3 on")
    extents = []
    for li, lvl in enumerate(levels):
        shape, R, pk, offs = tuple(lvl.diag.shape), lvl.width, lvl.padded, \
            lvl.offsets
        x = torch.randn(shape, generator=gen, device=dev)
        r = torch.randn(shape, generator=gen, device=dev)
        xp = halo_exchange_x(x, lvl.periodic_x, mesh, R)
        rp = pad_x(r, R)
        case = (f"rank {mesh.rank} {label} SA level {li + 1} slab "
                + "x".join(map(str, xp.shape)) + f" R={R} {len(offs)} taps")
        # the absolute tolerance in units of the level's largest diagonal
        # (as K2's): the Galerkin coefficients grow about 2x a level, and
        # an output that cancels keeps the rounding of its largest terms
        scale = max(1.0, float(lvl.diag.abs().max()))
        plain = {"apply": po.offset_apply_plain(xp, pk, offs),
                 "resid": po.offset_resid_plain(xp, rp, pk, offs),
                 "sweep": po.offset_sweep_plain(xp, rp, pk, offs, 0.9)}
        for mode, want in plain.items():
            got = oc.k3_offset(mode, xp, None if mode == "apply" else rp,
                               pk, offs, omega=0.9)
            chk.close(f"k3_{mode}_f32", got, want, torch.float32, case,
                      tol=K3_TOL, scale=scale)
        if lvl.nn < len(offs):
            chk.close("k3_apply_prefix_f32",
                      oc.k3_offset("apply", xp, None, pk, offs,
                                   n_taps=lvl.nn),
                      po.offset_apply_plain(xp, pk, offs, n_taps=lvl.nn),
                      torch.float32, case, tol=K3_TOL, scale=scale)
        for mode, got in (("apply", lvl.apply(x)), ("resid", lvl.resid(x, r)),
                          ("sweep", lvl.sweep(x, r, 0.9))):
            chk.close(f"k3_{mode}_f32", got, plain[mode][R:-R],
                      torch.float32, case + " slab form", tol=K3_TOL,
                      scale=scale)
        extents.append(tuple(xp.shape))
        del x, r, xp, rp, plain
    del M, levels
    cheb = ChebyshevPreconditioner.from_system(system)
    x = torch.randn(tuple(system.code.shape), generator=gen, device=dev)
    xp = halo_exchange_x(x, bool(system.periodic[0]), mesh)
    per = st.slab_periodic(system.periodic)
    case = f"rank {mesh.rank} {label} slab " + "x".join(map(str, xp.shape))
    want = st.apply_restricted_plain(xp, cheb.diag_halo, cheb.free_halo,
                                     system.w, per)
    chk.close("k5_matvec_f32", sc.k5_matvec_stream(
        xp, cheb.diag_halo, cheb.free_halo, system.w, per), want,
        torch.float32, case)
    chk.close("k5_matvec_f32", cheb._apply_A(x), want[1:-1], torch.float32,
              case + " slab form")
    return {"max_err": chk.max_err, "build": build, "k3_extents": extents,
            "k5_extent": tuple(xp.shape)}


# every preconditioner and Krylov method on the slabs (module docstring,
# 4b): label -> (the volume: "raw", the main volume's slabs read from the
# RAW file, or SOLVER_N, a blobs volume of that edge passed whole; the
# entry point; its keyword arguments; the kernels every rank must launch).
# mg and cheby run hundreds of iterations (PR 6's rule put main[cheby] on
# one card at 256^3 for that), and four ranks time-slicing the one card
# pay milliseconds per exchange, so they run at SOLVER_N, as does the
# periodic SA cell problem
SOLVER_N = 128
SHARDED_SOLVERS = {
    "sa": ("raw", "tau", {"precond": "sa"},
           ("k1_matvec_dot_f32", "k1_matvec_f32", "k1_resid_f32",
            "k1_sweep_f32", "k1_matvec_f64") + _K3),
    "fgmres": ("raw", "tau", {"method": "fgmres"},
               ("k1_matvec_f32", "k1_sweep_f32", "k1_restrict_f32",
                "k1_matvec_f64") + _K2),
    "mg": (SOLVER_N, "tau", {"precond": "mg"},
           ("k1_matvec_dot_f32", "k1_sweep_f32", "k1_restrict_f32",
            "k1_matvec_f64")),
    "cheby": (SOLVER_N, "tau", {"precond": "cheby"},
              ("k1_matvec_dot_f32", "k1_matvec_f64", "k5_matvec_f32")),
    "deff-sa": (SOLVER_N, "deff", {"precond": "sa"},
                ("k1_resid_f32", "k1_sweep_f32", "k1_matvec_f64") + _K3),
}


def _sharded_solver(mesh, raw_path, n, vol, entry, kw):
    """One run of ``SHARDED_SOLVERS`` on this rank, counted by
    ``_rank_tau``; ``vol`` None: the main volume's slab from the RAW
    file."""
    from openimpala_tpu_torch import effective_diffusivity, tortuosity
    from openimpala_tpu_torch.io import RawReader, threshold_sharded

    dev, timings = mesh.device, {}
    if vol is None:
        def call():
            slab, shape = threshold_sharded(RawReader(raw_path, n, n, n,
                                                      "UINT8"), 0.5, mesh)
            return tortuosity(slab, 1, "X", eps=1e-9, mesh=mesh,
                              original_shape=shape, device=dev,
                              timings=timings, **kw)
    elif entry == "deff":
        def call():
            return effective_diffusivity(vol, 1, eps=1e-9, mesh=mesh,
                                         device=dev, timings=timings, **kw)
    else:
        def call():
            return tortuosity(vol, 1, "X", eps=1e-9, mesh=mesh, device=dev,
                              timings=timings, **kw)
    torch.cuda.empty_cache()
    _, out = _rank_tau(call, mesh, _DEFF_KEYS if entry == "deff"
                       else _TAU_KEYS)
    out["step_s"] = timings
    return out


_DEFF_KEYS = ("deff", "iterations", "rel_res", "converged", "lanes",
              "volume_fraction")


def _rank_deff(mesh, reader):
    """``effective_diffusivity`` of this rank's slab of the main volume
    (the 512^3 homogenisation on slabs, lanes where the rank-aware gate
    admits them), counted by ``_rank_tau``; and the gate's answer."""
    from openimpala_tpu_torch import effective_diffusivity
    from openimpala_tpu_torch.io import threshold_sharded
    from openimpala_tpu_torch.solve.lanes import use_lanes

    slab, shape = threshold_sharded(reader, 0.5, mesh)
    admits = use_lanes(int(np.prod(shape)), 3, "cg", mesh=mesh)
    torch.cuda.empty_cache()
    timings = {}
    _, out = _rank_tau(lambda: effective_diffusivity(
        slab, 1, eps=1e-9, mesh=mesh, original_shape=shape,
        device=mesh.device, timings=timings), mesh, _DEFF_KEYS)
    out.update(admits=admits, step_s=timings)
    return slab, out


def _sharded_rank(mesh, raw_path, n, small, solver_vols):
    """One rank of the ``sharded`` phase (run by ``parallel.spawn``): the
    main volume's slab from the RAW file into ``tortuosity``, K1 and K2
    against their plain forms on the slab layouts and K3 and K5 on the
    padded slabs of that system, the same slab into
    ``effective_diffusivity`` and the kernels again on the slab of its
    periodic cell problem, then the smaller volumes whole under the mesh,
    then every run of ``SHARDED_SOLVERS`` (``solver_vols``: edge -> the
    blobs volume) and K3 and K5 on the slab of the SA cell problem.
    Returns host values only."""
    from openimpala_tpu_torch import tortuosity
    from openimpala_tpu_torch.io import RawReader, threshold_sharded
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system, make_tortuosity_system)
    from openimpala_tpu_torch.parallel.mesh import shard_volume
    from openimpala_tpu_torch.props.volume_fraction import (
        volume_fraction_counts)

    dev = mesh.device
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(dev), "staged": mesh.staged}
    timings = {}

    held = {}

    def main_call():
        slab, shape = threshold_sharded(RawReader(raw_path, n, n, n,
                                                  "UINT8"), 0.5, mesh)
        out["slab"] = tuple(slab.shape)
        held["slab"] = slab
        return tortuosity(slab, 1, "X", eps=1e-9, mesh=mesh,
                          original_shape=shape, device=dev,
                          timings=timings, return_fields=True)

    res, out["main"] = _rank_tau(main_call, mesh)
    out["main"]["step_s"] = timings
    # the reference's skip-the-reduction volume fraction on the main slab
    slab = held.pop("slab")
    out["vf"] = {"local": volume_fraction_counts(slab, 1, mesh=mesh,
                                                 local=True),
                 "reduced": volume_fraction_counts(slab, 1, mesh=mesh)}
    del slab
    flow = make_tortuosity_system(res.active, 0, -1.0, 1.0,
                                  dtype=torch.float32, mesh=mesh)
    del res
    out["slab_kernels"] = _slab_kernel_checks(mesh, flow, "flow")
    out["slab_k3_k5"] = _slab_k3_k5_checks(mesh, flow, "flow")
    del flow
    torch.cuda.empty_cache()
    slab, out["deff"] = _rank_deff(mesh, RawReader(raw_path, n, n, n,
                                                   "UINT8"))
    out["cell_kernels"] = _slab_kernel_checks(mesh, make_cell_problem_system(
        slab == 1, 0, dtype=torch.float32, mesh=mesh), "cell")
    del slab
    torch.cuda.empty_cache()
    for name, vol in small.items():
        _, out[name] = _rank_tau(lambda: tortuosity(
            vol, 1, "X", eps=1e-9, mesh=mesh, device=dev), mesh)
    for label, (src, entry, kw, _) in SHARDED_SOLVERS.items():
        out[label] = _sharded_solver(mesh, raw_path, n, solver_vols.get(src),
                                     entry, kw)
    # the SA cell problem's slab: K3 and K5 across the periodic seam
    cell = make_cell_problem_system(
        shard_volume(torch.from_numpy(solver_vols[SOLVER_N] == 1), mesh)
        .to(dev), 0, dtype=torch.float32, mesh=mesh)
    out["cell_k3_k5"] = _slab_k3_k5_checks(mesh, cell, "cell")
    return out


def _require_sharded_tau(label, got, want_tau, want_vf, want_its):
    rel = abs(got["value"] - want_tau) / abs(want_tau)
    require(got["converged"] and got["flux_conserved"],
            f"sharded[{label}]: converged={got['converged']} "
            f"flux_conserved={got['flux_conserved']}")
    require(rel <= 1e-6, f"sharded[{label}]: tau {got['value']!r} differs "
                         f"from the single-device {want_tau!r} by {rel:.3e}")
    require(got["active_vf"] == want_vf,
            f"sharded[{label}]: active_vf {got['active_vf']!r} != "
            f"{want_vf!r}")
    require(abs(got["iterations"] - want_its) <= 2,
            f"sharded[{label}]: {got['iterations']} iterations against "
            f"{want_its}")
    return rel


def phase_sharded(chk, vol, n, runs):
    """The X-slab decomposition on ``SHARDED_RANKS`` ranks (module
    docstring, 4b).  ``runs``: the main paths' runs (``iso``'s tau and
    ``deff``'s tensor are the references).  Returns the launches of the
    512^3 solves summed over the ranks."""
    iso = runs["iso"]
    import shutil
    import tempfile
    from pathlib import Path

    from openimpala_tpu_torch import effective_diffusivity, tortuosity
    from openimpala_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    small = {name: _small_volume(name) for name in SHARDED_SMALL}
    refs = {}
    for name, v in small.items():
        t0 = time.perf_counter()
        r = tortuosity(v, 1, "X", eps=1e-9, device="cuda")
        refs[name] = (r.value, r.active_vf, r.iterations)
        log(f"sharded[{name}] single-device {'x'.join(map(str, v.shape))}: "
            f"tau={r.value!r} active_vf={r.active_vf!r} "
            f"iterations={r.iterations} wall_s={time.perf_counter() - t0:.3f}")
    # the single-card references of SHARDED_SOLVERS: the 512^3 main
    # paths with the same solver (main[sa]; main[cli], FGMRES with the
    # default cycle), and calls here at SOLVER_N
    ns = min(n, SOLVER_N)
    solver_vols = {SOLVER_N: make_blobs(ns, 0.4, SEED)}
    solver_refs = {"sa": runs["sa"], "fgmres": dict(
        runs["cli"], active_vf=iso["active_vf"],
        peak_mem_GB=runs["cli"]["peak_bytes"] / 1e9)}
    for label, (src, entry, kw, _) in SHARDED_SOLVERS.items():
        if src == "raw":
            continue
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        if entry == "deff":
            r = effective_diffusivity(solver_vols[src], 1, eps=1e-9,
                                      device="cuda", **kw)
            ref = {"deff": np.asarray(r.deff),
                   "per_direction": tuple(r.iterations)}
        else:
            r = tortuosity(solver_vols[src], 1, "X", eps=1e-9,
                           device="cuda", **kw)
            ref = {"tau": r.value, "active_vf": r.active_vf,
                   "iterations": r.iterations}
        ref.update(wall_s=time.perf_counter() - t0,
                   peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9)
        solver_refs[label] = ref
        log(f"sharded[{label}] single-device {ns}^3 {kw}: "
            + ", ".join(f"{k}={v!r}" for k, v in ref.items()
                        if k != "deff") + (f", D_xx={ref['deff'][0][0]!r}"
                                           if "deff" in ref else ""))
        del r
    torch.cuda.empty_cache()  # the ranks need the card's memory
    log(f"sharded: volumes and single-device references "
        f"{time.perf_counter() - t_phase:.1f} s")
    if torch.cuda.device_count() >= SHARDED_RANKS:
        backend, device = "nccl", "cuda"  # one rank per card
    else:
        backend, device = "gloo", "cuda:0"  # every rank on the one card
    log(f"sharded: {SHARDED_RANKS} ranks, backend {backend}, device "
        f"{device} ({torch.cuda.device_count()} card(s))")
    raw = _main_raw(vol)  # the CLI path's file
    tmp = Path(tempfile.mkdtemp(prefix="sharded_"))
    try:
        t0 = time.perf_counter()
        world = spawn.World("chip_smoke:_sharded_rank", SHARDED_RANKS,
                            args=(str(raw), n, small, solver_vols),
                            backend=backend,
                            device=device, timeout=SHARDED_TIMEOUT,
                            workdir=tmp / "world", threads=2)
        try:
            ranks = world.wait()
        except (RuntimeError, TimeoutError) as e:
            raise SmokeFailure(f"sharded: {e}") from None
        log(f"sharded: the world ran {time.perf_counter() - t0:.1f} s "
            f"(spawn, CUDA start-up and every call)")
        for r, text in enumerate(spawn.run_logs(world.workdir)):
            for line in text.strip().splitlines()[-5:]:
                log(f"sharded rank {r} said: {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    launches = collections.Counter()
    for out in ranks:
        m, rank = out["main"], out["rank"]
        log(f"sharded[main] rank {rank}/{out['size']} {out['backend']} "
            f"{out['device']} slab {out['slab']}: tau={m['value']!r} "
            f"active_vf={m['active_vf']!r} iterations={m['iterations']} "
            f"rel_res={m['rel_res']!r} flux_rel_diff="
            f"{m['flux_rel_diff']!r} percolation={m['percolation_method']} "
            f"wall_s={m['wall_s']:.3f} peak_mem_GB={m['peak_mem_GB']:.2f} "
            f"host-staged collectives={out['staged']}")
        log(f"sharded[main] rank {rank} step_s " + json.dumps(
            {k: round(v, 4) for k, v in m["step_s"].items()}))
        log(f"sharded[main] rank {rank} comm " + json.dumps(m["comm"])
            + " launches " + json.dumps(m["counts"], sort_keys=True))
        missing = [k for k in SHARDED_KERNELS if not m["counts"].get(k)]
        require(not missing, f"sharded[main] rank {rank}: never launched "
                             f"{missing}")
        require(not m["plain"], f"sharded[main] rank {rank}: plain versions "
                                f"ran on CUDA tensors: {m['plain']}")
        require(m["counts"]["k1_matvec_dot_f32"] >= m["iterations"],
                f"sharded[main] rank {rank}: K1 matvec+dot launched "
                f"{m['counts']['k1_matvec_dot_f32']} times for "
                f"{m['iterations']} iterations")
        for key in ("value", "iterations", "active_vf", "rel_res"):
            require(m[key] == ranks[0]["main"][key],
                    f"sharded[main]: rank {rank}'s {key} {m[key]!r} differs "
                    f"from rank 0's {ranks[0]['main'][key]!r}")
        launches.update(m["counts"])
        for key, what in (("slab_kernels", "flow-through"),
                          ("cell_kernels", "periodic cell problem")):
            k = out[key]
            log(f"sharded[slab kernels] rank {rank} {what}: K1 on "
                f"{k['shape']} route {k['route']}, K2 on {k['k2_shapes']}: "
                + json.dumps({name: f"{e:.2e}" for name, e in
                              k["max_err"].items()}))
            for name, e in k["max_err"].items():
                chk.max_err[name] = max(chk.max_err.get(name, 0.0), e)
                chk.max_err[f"{name}.slab"] = max(
                    chk.max_err.get(f"{name}.slab", 0.0), e)
        launches.update(_require_sharded_deff(out, ranks[0]["deff"],
                                              runs["deff"]))
    pairs = [tuple(out["vf"]["local"]) for out in ranks]
    reduced = tuple(ranks[0]["vf"]["reduced"])
    log(f"sharded[vf] volume_fraction_counts(local=True) per rank "
        f"{pairs}, summed {tuple(map(sum, zip(*pairs)))}, mesh-reduced "
        f"{reduced}")
    require(tuple(map(sum, zip(*pairs))) == reduced,
            f"sharded[vf]: the ranks' local pairs {pairs} do not sum to the "
            f"reduced pair {reduced}")
    require(all(tuple(out["vf"]["reduced"]) == reduced for out in ranks),
            "sharded[vf]: the ranks' reduced pairs differ")
    require(reduced[1] == n ** 3, f"sharded[vf]: total {reduced[1]} is not "
                                  f"{n}^3")
    m = ranks[0]["main"]
    rel = _require_sharded_tau("main", m, iso["tau"], iso["active_vf"],
                               iso["iterations"])
    log(f"sharded[main] {n}^3 on {len(ranks)} ranks: tau={m['value']!r} "
        f"against main[iso] {iso['tau']!r} (rel {rel:.3e}), iterations "
        f"{m['iterations']} against {iso['iterations']}, wall_s "
        f"{max(o['main']['wall_s'] for o in ranks):.3f} against "
        f"{iso['wall_s']:.3f}, peak_mem_GB per rank "
        + ", ".join(f"{o['main']['peak_mem_GB']:.2f}" for o in ranks)
        + f" against {iso.get('peak_mem_GB', float('nan')):.2f}")
    d = ranks[0]["deff"]
    log(f"sharded[deff] {n}^3 on {len(ranks)} ranks: D_xx={d['deff'][0][0]!r}"
        f" against main[deff] {runs['deff']['value']!r}, iterations "
        f"{d['iterations']} against {runs['deff']['per_direction']}, lanes="
        f"{d['lanes']} (the rank-aware gate admits: {d['admits']}), wall_s "
        f"{max(o['deff']['wall_s'] for o in ranks):.3f} against "
        f"{runs['deff']['wall_s']:.3f}, peak_mem_GB per rank "
        + ", ".join(f"{o['deff']['peak_mem_GB']:.2f}" for o in ranks)
        + f" against {runs['deff'].get('peak_mem_GB', float('nan')):.2f}")
    for name in SHARDED_SMALL:
        got = ranks[0][name]
        for out in ranks:
            require(out[name]["value"] == got["value"],
                    f"sharded[{name}]: the ranks disagree")
            require(not out[name]["plain"],
                    f"sharded[{name}]: plain versions ran on CUDA tensors: "
                    f"{out[name]['plain']}")
        rel = _require_sharded_tau(name, got, *refs[name])
        log(f"sharded[{name}]: tau={got['value']!r} (rel {rel:.3e} to the "
            f"single-device call) iterations={got['iterations']} "
            f"percolation={got['percolation_method']} wall_s="
            f"{max(o[name]['wall_s'] for o in ranks):.3f} comm "
            + json.dumps(got["comm"]))
    for out in ranks:
        for key in ("slab_k3_k5", "cell_k3_k5"):
            k = out[key]
            log(f"sharded[slab K3/K5] rank {out['rank']} {key}: SA build "
                f"{k['build']['s']:.3f} s, gathered at level "
                f"{k['build']['gather']}, taps {k['build']['taps']}, comm "
                + json.dumps(k["build"]["comm"]) + f"; K3 on {k['k3_extents']}"
                f", K5 on {k['k5_extent']}: " + json.dumps(
                    {name: f"{e:.2e}" for name, e in k["max_err"].items()}))
            for name, e in k["max_err"].items():
                chk.max_err[name] = max(chk.max_err.get(name, 0.0), e)
                chk.max_err[f"{name}.slab"] = max(
                    chk.max_err.get(f"{name}.slab", 0.0), e)
    launches.update(_require_sharded_solvers(ranks, solver_refs, n, ns))
    return dict(launches)


def _require_sharded_solvers(ranks, refs, n, ns):
    """Every run of ``SHARDED_SOLVERS``, logged per rank (wall, peak,
    traffic, steps, launches) and held to the single-card call (``refs``:
    tau within 1e-6, iterations or Arnoldi steps within 2; the tensor
    within 1e-6 of its largest entry, iterations within 2 per direction),
    to rank 0's bits, and to its kernels on every rank: the kernels the
    run names, no plain form on a CUDA tensor; ``sa`` and ``deff-sa`` K3
    at every sharded level's padded extent (the extents of
    ``_slab_k3_k5_checks``' hierarchies), ``cheby`` K5 on the slab padded
    by one plane (7 per iteration, no K4), ``mg`` K1 on every sharded
    level in K1's slab layout and on the gathered ones, ``fgmres`` K1's
    matvec once per Arnoldi step at least.  Returns the launches summed
    over the ranks."""
    from openimpala_tpu_torch.solve.preconditioners import mg_depth
    from openimpala_tpu_torch.solve.slab_mg import gather_level

    size = len(ranks)
    xl = ns // size
    depth = mg_depth((ns,) * 3, 10)
    g = gather_level(xl, ((0, 1, 2),) * depth)
    mg_extents = ([((xl >> k) + 4, ns >> k, ns >> k) for k in range(g)]
                  + [(ns >> k,) * 3 for k in range(g, depth + 1)])
    launches = collections.Counter()
    for label, (src, entry, kw, kernels) in SHARDED_SOLVERS.items():
        first, ref = ranks[0][label], refs[label]
        result = "deff" if entry == "deff" else "value"
        for out in ranks:
            m, rank = out[label], out["rank"]
            shown = (f"D_xx={m['deff'][0][0]!r}" if entry == "deff"
                     else f"tau={m['value']!r}")
            log(f"sharded[{label}] rank {rank}: {shown} iterations="
                f"{m['iterations']} rel_res={m['rel_res']!r} wall_s="
                f"{m['wall_s']:.3f} peak_mem_GB={m['peak_mem_GB']:.2f} comm "
                + json.dumps(m["comm"]))
            log(f"sharded[{label}] rank {rank} step_s " + json.dumps(
                {k: round(v, 4) for k, v in m["step_s"].items()})
                + " launches " + json.dumps(m["counts"], sort_keys=True))
            missing = [k for k in kernels if not m["counts"].get(k)]
            require(not missing, f"sharded[{label}] rank {rank}: never "
                                 f"launched {missing}")
            require(not m["plain"], f"sharded[{label}] rank {rank}: plain "
                                    f"versions ran on CUDA tensors: "
                                    f"{m['plain']}")
            for key in (result, "iterations", "rel_res"):
                require(np.array_equal(m[key], first[key]),
                        f"sharded[{label}]: rank {rank}'s {key} {m[key]!r} "
                        f"differs from rank 0's {first[key]!r}")
            if label in ("sa", "deff-sa"):
                want = out["slab_k3_k5" if label == "sa"
                           else "cell_k3_k5"]["k3_extents"]
                bare = [e for e in want if not any(
                    m["at"].get((k, e)) for k in _K3)]
                require(not bare, f"sharded[{label}] rank {rank}: no K3 "
                                  f"launch on the padded slabs {bare}")
            elif label == "cheby":
                ext = (xl + 2, ns, ns)
                c = m["counts"]
                require(m["at"].get(("k5_matvec_f32", ext), 0)
                        == c["k5_matvec_f32"],
                        f"sharded[cheby] rank {rank}: K5 launched off the "
                        f"padded slab {ext}: {m['at']}")
                require(c["k5_matvec_f32"] == (CHEBY_DEGREE - 1)
                        * c["k1_matvec_dot_f32"],
                        f"sharded[cheby] rank {rank}: K5 {c['k5_matvec_f32']}"
                        f" times for {c['k1_matvec_dot_f32']} applications")
                require(not any(k.startswith("k4_") for k in c),
                        f"sharded[cheby] rank {rank}: K4 launched")
            elif label == "mg":
                bare = [e for e in mg_extents if not m["k1_at"].get(e)]
                require(not bare, f"sharded[mg] rank {rank}: no K1 launch "
                                  f"at the levels {bare} (K1 by extent "
                                  f"{m['k1_at']})")
            elif label == "fgmres":
                mv = m["counts"].get("k1_matvec_f32", 0)
                require(mv >= m["iterations"],
                        f"sharded[fgmres] rank {rank}: K1 matvec {mv} times "
                        f"for {m['iterations']} Arnoldi steps")
            launches.update(m["counts"])
        if entry == "deff":
            scale = float(np.abs(ref["deff"]).max())
            err = float(np.abs(first["deff"] - ref["deff"]).max())
            require(first["converged"] and err <= 1e-6 * scale,
                    f"sharded[{label}]: converged={first['converged']}, the "
                    f"tensor {err:.3e} from one card's (largest {scale:.3e})")
            require(all(abs(a - b) <= 2 for a, b in zip(
                first["iterations"], ref["per_direction"])),
                f"sharded[{label}]: iterations {first['iterations']} "
                f"against {ref['per_direction']}")
            vs = (f"D_xx {first['deff'][0][0]!r} (tensor {err:.3e} from "
                  "one card's)")
        else:
            rel = _require_sharded_tau(label, first, ref["tau"],
                                       ref["active_vf"], ref["iterations"])
            vs = f"tau {first['value']!r} (rel {rel:.3e} to one card's)"
        where = f"{n}^3 from the RAW file" if src == "raw" else f"{ns}^3"
        log(f"sharded[{label}] {where} on {size} ranks {kw}: {vs}, "
            f"iterations {first['iterations']} "
            f"against {ref.get('iterations', ref.get('per_direction'))}, "
            f"wall_s {max(o[label]['wall_s'] for o in ranks):.3f} against "
            f"{ref['wall_s']:.3f}, peak_mem_GB per rank "
            + ", ".join(f"{o[label]['peak_mem_GB']:.2f}" for o in ranks)
            + f" against {ref.get('peak_mem_GB', float('nan')):.2f}; "
            "traffic per rank " + json.dumps([o[label]["comm"]
                                              for o in ranks]))
    return launches


def _require_sharded_deff(out, first, single):
    """One rank's ``sharded[deff]``: logged and held to ``main[deff]``
    (``single``: its tensor within 1e-6 of its largest entry, iterations
    within 2 per direction), to rank 0's bits (``first``), and to the
    launches of its path.  Returns the rank's launches."""
    d, rank = out["deff"], out["rank"]
    log(f"sharded[deff] rank {rank}: deff={d['deff'].tolist()!r} "
        f"iterations={d['iterations']} rel_res={d['rel_res']!r} "
        f"lanes={d['lanes']} admits={d['admits']} "
        f"wall_s={d['wall_s']:.3f} peak_mem_GB={d['peak_mem_GB']:.2f}")
    log(f"sharded[deff] rank {rank} step_s " + json.dumps(
        {k: round(v, 4) for k, v in d["step_s"].items()}))
    log(f"sharded[deff] rank {rank} comm " + json.dumps(d["comm"])
        + " launches " + json.dumps(d["counts"], sort_keys=True))
    require(d["converged"] and max(d["rel_res"]) <= 1e-9,
            f"sharded[deff] rank {rank}: converged={d['converged']} "
            f"rel_res={d['rel_res']}")
    for key in ("iterations", "rel_res", "lanes"):
        require(d[key] == first[key], f"sharded[deff]: rank {rank}'s {key} "
                                      f"{d[key]!r} differs from rank 0's")
    require(np.array_equal(d["deff"], first["deff"]),
            f"sharded[deff]: rank {rank}'s tensor differs from rank 0's")
    require(d["admits"] and d["lanes"],
            f"sharded[deff] rank {rank}: lanes={d['lanes']}, the "
            f"rank-aware gate admits {d['admits']}")
    scale = float(np.abs(single["deff"]).max())
    err = float(np.abs(d["deff"] - single["deff"]).max())
    require(err <= 1e-6 * scale,
            f"sharded[deff]: the tensor differs from main[deff]'s by "
            f"{err:.3e} (largest entry {scale:.3e})")
    require(all(abs(a - b) <= 2 for a, b in zip(d["iterations"],
                                                single["per_direction"])),
            f"sharded[deff]: iterations {d['iterations']} against "
            f"{single['per_direction']}")
    missing = [k for k in SHARDED_KERNELS if not d["counts"].get(k)]
    require(not missing, f"sharded[deff] rank {rank}: never launched "
                         f"{missing}")
    require(not d["plain"], f"sharded[deff] rank {rank}: plain versions ran "
                            f"on CUDA tensors: {d['plain']}")
    return d["counts"]


# sharded[cli]: the port's CLI under ``python -m torch.distributed.run`` on
# SHARDED_RANKS ranks (gloo on the one card), homogenisation of a
# CLI_SHAPE volume of the blobs recipe written as an uncompressed
# multi-page TIFF: Z = 254 does not divide by 4, so the Z-page split pads
CLI_SHAPE = (256, 256, 254)
CLI_TIMEOUT = 300.0


def _stdout_by_rank(log_dir):
    """Each rank's standard output from ``torch.distributed.run``'s
    ``--log-dir`` (``.../<local rank>/stdout.log``)."""
    from pathlib import Path

    return {int(p.parent.name): p.read_text()
            for p in Path(log_dir).rglob("stdout.log")}


def _tensor_rows(text):
    rows = [line.strip() for line in text.splitlines()
            if line.strip().startswith("[") and line.strip().endswith("]")]
    return np.array([[float(v) for v in r.strip("[]").split(",")]
                     for r in rows])


def phase_sharded_cli(tmp):
    """The port's CLI on ``SHARDED_RANKS`` ranks (module docstring, 4b):
    its return code, rank 0's printed tensor against a single-card
    ``effective_diffusivity`` call here on the same thresholded volume,
    no result from the other ranks, the ingest's all-to-all bytes, and
    each rank's launches in the calculation (``OPENIMPALA_LAUNCH_COUNTS``):
    every kernel of ``SHARDED_KERNELS``, no plain form on a CUDA tensor.
    Returns the launches summed over the ranks."""
    import os

    from openimpala_tpu_torch import effective_diffusivity
    from openimpala_tpu_torch.io.tiff_raw import write_tiff

    X, Y, Z = CLI_SHAPE
    vol = make_blobs(X, 0.4, SEED)[:, :Y, :Z]
    t0 = time.perf_counter()
    write_tiff(os.path.join(tmp, "cli.tif"),
               ((vol[:, :, z].T * 255).astype(np.uint8) for z in range(Z)),
               big=False)
    inputs = os.path.join(tmp, "cli.inputs")
    with open(inputs, "w") as f:
        f.write(f"filename = cli.tif\ndata_path = {tmp}/\n"
                f"results_path = {tmp}/results/\nphase_id = 1\n"
                "calculation_method = homogenization\nhypre.eps = 1e-9\n"
                "verbose = 1\n")
    ref = effective_diffusivity(vol, 1, eps=1e-9, device="cuda")
    log(f"sharded[cli] {X}x{Y}x{Z} TIFF written and the single-card "
        f"reference solved in {time.perf_counter() - t0:.1f} s: "
        f"D_xx={ref.deff[0, 0]!r} iterations={ref.iterations}")
    log_dir = os.path.join(tmp, "logs")
    counts_dir = os.path.join(tmp, "cli_counts")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(SHARDED_RANKS), "--log-dir", log_dir,
           "--redirects", "3", "-m", "openimpala_tpu_torch.diffusion",
           inputs]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OPENIMPALA_LAUNCH_COUNTS=counts_dir,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT, env=env)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"sharded[cli]: torch.distributed.run did not "
                           f"end within {CLI_TIMEOUT:.0f} s") from None
    wall = time.perf_counter() - t0
    outs = _stdout_by_rank(log_dir)
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-8:]:
        log(f"sharded[cli] launcher said: {line}")
    require(proc.returncode == 0 and sorted(outs) == list(
        range(SHARDED_RANKS)),
        f"sharded[cli]: return code {proc.returncode}, ranks' output "
        f"{sorted(outs)}; rank 0 said: {outs.get(0, '')[-2000:]}")
    got = _tensor_rows(outs[0])
    require(got.shape == (3, 3), f"sharded[cli]: rank 0 printed no tensor: "
                                 f"{outs[0][-2000:]}")
    quiet = {r: o for r, o in outs.items() if r and o.strip()}
    require(not quiet, f"sharded[cli]: ranks {sorted(quiet)} printed: "
                       f"{json.dumps(quiet)[:2000]}")
    scale = float(np.abs(ref.deff).max())
    err = float(np.abs(got - ref.deff).max())
    ingest = [line.strip() for line in outs[0].splitlines()
              if "Distributed ingest" in line]
    log(f"sharded[cli] torch.distributed.run x{SHARDED_RANKS}: rc 0 in "
        f"{wall:.1f} s; rank 0's tensor {got.tolist()!r}, max abs diff "
        f"{err:.3e} from the single-card call; {ingest}; "
        + "; ".join(line.strip() for line in outs[0].splitlines()
                    if "Total run time" in line))
    require(err <= 1e-6 * scale, f"sharded[cli]: the tensor differs from "
                                 f"the single-card call by {err:.3e}")
    require(ingest and "bytes of Z pages" in ingest[0],
            f"sharded[cli]: no Z-page ingest reported: {ingest}")
    launches = collections.Counter()
    for rank in range(SHARDED_RANKS):
        path = os.path.join(counts_dir, f"rank{rank}.json")
        require(os.path.exists(path),
                f"sharded[cli] rank {rank}: wrote no launch counts")
        with open(path) as f:
            got = json.load(f)
        log(f"sharded[cli] rank {rank} launches "
            + json.dumps(got["launches"], sort_keys=True))
        missing = [k for k in SHARDED_KERNELS if not got["launches"].get(k)]
        require(not missing, f"sharded[cli] rank {rank}: never launched "
                             f"{missing}")
        require(not got["plain_on_cuda"],
                f"sharded[cli] rank {rank}: plain versions ran on CUDA "
                f"tensors: {got['plain_on_cuda']}")
        launches.update(got["launches"])
    return dict(launches)


def _graph_key(name, out):
    """What a graphed run and its eager twin must share: the result and
    the iterations."""
    if name in ("iso", "sa"):
        return (out.value, out.iterations, out.rel_res)
    if name == "deff":
        return (out.deff.tolist(), out.iterations, out.rel_res, out.lanes)
    return [s.deff.tolist() for s in out]


def phase_graph(seed):
    """At GRAPH_N^3: ``tortuosity`` (default and ``sa``),
    ``effective_diffusivity`` through the lanes and ``rev_study`` (64^3
    crops), each graphed and then as its eager twin, the counters zeroed
    before each: the results, the iterations and every launch counter must
    be equal."""
    from openimpala_tpu_torch import (effective_diffusivity, rev_study,
                                      tortuosity)

    vol = make_blobs(GRAPH_N, 0.4, seed)
    cases = {
        "iso": lambda: tortuosity(vol, 1, "X", eps=1e-9, device="cuda"),
        "sa": lambda: tortuosity(vol, 1, "X", eps=1e-9, precond="sa",
                                 device="cuda"),
        "deff": lambda: effective_diffusivity(vol, 1, eps=1e-9, lanes=True,
                                              device="cuda"),
        "rev": lambda: rev_study(vol, 1, sizes=(min(REV_SIZE, GRAPH_N),),
                                 num_samples=GRAPH_REV_SAMPLES, eps=1e-9,
                                 device="cuda"),
    }
    for name, call in cases.items():
        _reset()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_counts()
        gstats = _graph_stats(f"graph {GRAPH_N}^3 {name}")
        twin, twin_counts, twin_wall, tstats = _eager_twin(call)
        got, want = _graph_key(name, out), _graph_key(name, twin)
        equal = _less_surplus(counts, gstats) == twin_counts
        log(f"graph {GRAPH_N}^3 {name}: graphed {str(got)[:160]} wall_s="
            f"{wall:.3f}; eager twin wall_s={twin_wall:.3f}; results equal: "
            f"{got == want}; counters equal: {equal} ("
            f"{sum(counts['launches'].values())} launches)")
        require(gstats["replays"] >= 1,
                f"graph[{name}]: no step was replayed: {gstats}")
        _require_twin(f"graph {name}", got, want, counts, twin_counts,
                      gstats, tstats)


def phase_rules(seed):
    """``maxiter`` as a hard cap on the card, through the entry points at
    GRAPH_N^3 (the default tau there needs 46 iterations, each cell
    problem 16): ``tortuosity`` with ``maxiter=RULES_TAU_MAXITER`` under
    ``precond="auto"`` and ``"jacobi"`` must stop at exactly that many
    iterations, unconverged, tau NaN; ``effective_diffusivity`` with
    ``maxiter=RULES_DEFF_MAXITER``, through the lanes and the sequential
    loop, must count no more than that in any direction."""
    from openimpala_tpu_torch import effective_diffusivity, tortuosity

    vol = make_blobs(GRAPH_N, 0.4, seed)
    cap = RULES_TAU_MAXITER
    for precond in ("auto", "jacobi"):
        res = tortuosity(vol, 1, "X", eps=1e-9, precond=precond,
                         maxiter=cap, device="cuda")
        log(f"rules {GRAPH_N}^3 tortuosity precond={precond} maxiter={cap}: "
            f"iterations={int(res.iterations)} tau={res.value!r} "
            f"converged={res.converged} rel_res={res.rel_res!r}")
        require(int(res.iterations) == cap and not res.converged
                and np.isnan(res.value),
                f"rules[tau {precond}]: {int(res.iterations)} iterations, "
                f"converged={res.converged}, tau={res.value!r} under "
                f"maxiter={cap}")
    cap = RULES_DEFF_MAXITER
    for lanes in (True, False):
        res = effective_diffusivity(vol, 1, eps=1e-9, maxiter=cap,
                                    lanes=lanes, device="cuda")
        log(f"rules {GRAPH_N}^3 effective_diffusivity lanes={lanes} "
            f"maxiter={cap}: iterations={res.iterations} "
            f"converged={res.converged} rel_res={res.rel_res!r}")
        require(res.lanes == lanes and all(0 < it <= cap
                                           for it in res.iterations),
                f"rules[deff lanes={lanes}]: iterations {res.iterations} "
                f"under maxiter={cap}")


def _both(call):
    """``call("cuda")`` and ``call("cpu")``, and the wall seconds of each."""
    out, secs = [], []
    for dev in ("cuda", "cpu"):
        res, sec = _wall(lambda: call(dev))
        out.append(res)
        secs.append(round(sec, 3))
    return out, secs


PARITY_SOLVERS = (
    # the rediscretised cycle is a weak one (about 165 iterations at 64^3),
    # and float32 rounding, which differs between the card and the CPU,
    # moves where it crosses eps by a few iterations: it is held in float64
    ("mg f64", {"precond": "mg", "inner_dtype": None}),
    ("gmg-tri", {"precond_opts": {"transfer": "tri"}}),
    ("gmg-w", {"precond_opts": {"cycle": "w"}}),
    ("gmg-cheby", {"precond_opts": {"smoother": "cheby"}}),
    ("fgmres", {"method": "fgmres"}),
)


def phase_parity(seed):
    from openimpala_tpu_torch import effective_diffusivity, tortuosity

    vol = make_blobs(64, 0.4, seed)
    (gpu, cpu), secs = _both(lambda dev: effective_diffusivity(
        vol, 1, eps=1e-9, device=dev))
    err = float(np.abs(gpu.deff - cpu.deff).max())
    log(f"parity 64^3 effective_diffusivity: deff gpu={gpu.deff.tolist()!r} "
        f"max abs diff to cpu={err:.3e} iterations gpu={gpu.iterations} "
        f"cpu={cpu.iterations} seconds gpu, cpu {secs}")
    require(gpu.converged and cpu.converged and err <= 1e-6,
            f"parity[deff]: tensors differ by {err:.3e} > 1e-6")
    require(gpu.volume_fraction == cpu.volume_fraction,
            "parity[deff]: volume_fraction differs")
    for precond in ("auto", "sa"):
        (gpu, cpu), secs = _both(lambda dev: tortuosity(
            vol, 1, "X", eps=1e-9, precond=precond, device=dev))
        rel = abs(gpu.value - cpu.value) / abs(cpu.value)
        log(f"parity 64^3 precond={precond}: tau gpu={gpu.value!r} "
            f"cpu={cpu.value!r} rel={rel:.3e}"
            f" active_vf gpu={gpu.active_vf!r} cpu={cpu.active_vf!r} "
            f"iterations gpu={gpu.iterations} cpu={cpu.iterations} "
            f"percolation gpu={gpu.percolation_method} "
            f"cpu={cpu.percolation_method} seconds gpu, cpu {secs}")
        require(rel <= 1e-6, f"parity[{precond}]: tau rel diff {rel:.3e} "
                             "> 1e-6")
        require(gpu.active_vf == cpu.active_vf,
                f"parity[{precond}]: active_vf differs")
        require(abs(gpu.iterations - cpu.iterations) <= 1,
                f"parity[{precond}]: iterations differ by more than 1")
    # the solvers of this slice: tau within 1e-6 and the iterations within
    # 2, the window of the multigrid paths against the JAX package (1 in
    # float64)
    for name, kw in PARITY_SOLVERS:
        (gpu, cpu), secs = _both(lambda dev: tortuosity(
            vol, 1, "X", eps=1e-9, device=dev, **kw))
        rel = abs(gpu.value - cpu.value) / abs(cpu.value)
        log(f"parity 64^3 {name}: tau gpu={gpu.value!r} cpu={cpu.value!r} "
            f"rel={rel:.3e} iterations gpu={gpu.iterations} "
            f"cpu={cpu.iterations} seconds gpu, cpu {secs}")
        require(gpu.converged and cpu.converged and rel <= 1e-6,
                f"parity[{name}]: tau rel diff {rel:.3e} > 1e-6")
        require(gpu.active_vf == cpu.active_vf,
                f"parity[{name}]: active_vf differs")
        most = 1 if name.endswith("f64") else 2
        require(abs(gpu.iterations - cpu.iterations) <= most,
                f"parity[{name}]: iterations differ by more than {most}")
    for name, kw in (("mg", {"precond": "mg"}), ("fgmres",
                                                  {"method": "fgmres"})):
        (gpu, cpu), secs = _both(lambda dev: effective_diffusivity(
            vol, 1, eps=1e-9, device=dev, **kw))
        err = float(np.abs(gpu.deff - cpu.deff).max())
        log(f"parity 64^3 effective_diffusivity {name}: max abs diff to "
            f"cpu={err:.3e} iterations gpu={gpu.iterations} "
            f"cpu={cpu.iterations} seconds gpu, cpu {secs}")
        require(gpu.converged and cpu.converged and err <= 1e-6,
                f"parity[deff {name}]: tensors differ by {err:.3e}")
        require(all(abs(a - b) <= 2 for a, b in zip(gpu.iterations,
                                                    cpu.iterations)),
                f"parity[deff {name}]: iterations {gpu.iterations} against "
                f"{cpu.iterations}")


def _k1_fns(system, x, r, **plan):
    """name -> (kernel call, plain call, shape) for K1 on one system;
    ``plan`` (route, run, rows) overrides the launcher's own plan."""
    import functools

    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    k1 = functools.partial(sc.k1_stencil, **plan)
    code, w, per = system.code, system.w, system.periodic
    shape = tuple(code.shape)
    x64 = x.double()
    return {
        "k1_matvec_dot_f32": (
            lambda: k1("matvec", x, None, code, w, per, with_dot=True),
            lambda: st.apply_code_with_dot_plain(x, code, w, per), shape),
        "k1_matvec_f32": (
            lambda: k1("matvec", x, None, code, w, per),
            lambda: st.apply_code_plain(x, code, w, per), shape),
        "k1_resid_f32": (
            lambda: k1("resid", x, r, code, w, per),
            lambda: st.residual_restricted_plain(x, r, code, w, per), shape),
        "k1_sweep_f32": (
            lambda: k1("sweep", x, r, code, w, per, omega=0.9),
            lambda: st.smooth_sweep_plain(x, r, code, w, per, 0.9), shape),
        "k1_restrict_f32": (
            lambda: k1("restrict", x, r, code, w, per),
            lambda: st.residual_restrict_plain(x, r, code, w, per), shape),
        "k1_matvec_f64": (
            lambda: k1("matvec", x64, None, code, w, per),
            lambda: st.apply_code_plain(x64, code, w, per), shape),
    }


def _k2_fns(levels):
    """K2 on a path's Galerkin levels, each ``(level, x, r)``: the sweep
    and the matvec (the residual it restricts, once per V-cycle) run on
    level 1, where they are timed; the cheby step runs coarse_sweeps - 1
    times per V-cycle on the coarsest level after its zero start, where
    both are timed (the step updates its own ``res`` and ``x`` in place
    on every call)."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    (l1, x1, r1), (lc, xc, rc) = levels[0], levels[-1]
    c0, c1, c2 = CHEBY_C
    d, res, xs, spare = xc * 0.5, rc.clone(), xc.clone(), torch.empty_like(xc)
    return {
        "k2_sweep_f32": (
            lambda: sc.k2_conductance("sweep", x1, r1, l1.cx, l1.cy, l1.cz,
                                      l1.diag, omega=0.9),
            lambda: l1.sweep_plain(x1, r1, 0.9), tuple(l1.diag.shape)),
        "k2_matvec_f32": (
            lambda: sc.k2_conductance("matvec", x1, None, l1.cx, l1.cy, l1.cz,
                                      l1.diag),
            lambda: l1.apply_plain(x1), tuple(l1.diag.shape)),
        "k2_cheby_f32": (
            lambda: sc.k2_cheby(d, res, xs, lc.cx, lc.cy, lc.cz, lc.diag, c1,
                                c2, out=spare),
            lambda: lc.cheby_step_plain(rc, d, xc, c1, c2),
            tuple(lc.diag.shape)),
        "k2_cheby_init_f32": (
            lambda: sc.k2_cheby_init(rc, lc.diag, c0),
            lambda: lc.cheby_init_plain(rc, c0), tuple(lc.diag.shape)),
    }


# (c0, c1, c2) of the timed cheby steps: values of float32 (and float64)
CHEBY_C = (float(np.float32(0.9)), float(np.float32(1.05)),
           float(np.float32(0.48)))


def _times_k2_cheby(levels, seed):
    """K2's cheby step and its zero start on coarsest levels, each from a
    CUDA graph beside its bound (40 / 20 B a cell in float32, 80 / 40 in
    float64) and the unfused step's seven launches (K2 matvec and six
    elementwise kernels), whose result it must equal to the bit."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    rows = []
    c0, c1, c2 = CHEBY_C
    for lvl in levels:
        dtype = lvl.diag.dtype
        shape = tuple(lvl.diag.shape)
        gen = torch.Generator(device=lvl.diag.device).manual_seed(seed)
        r, x = (torch.where(lvl.free, torch.randn(
            shape, generator=gen, dtype=dtype, device=lvl.diag.device), 0.0)
            for _ in range(2))
        d = x * 0.5
        res, xs, spare = r.clone(), x.clone(), torch.empty_like(x)
        got = lvl.cheby_step(res.clone(), d, xs.clone(), c1, c2)
        want = _cheby_unfused(lvl, r, d, x, c1, c2, False)
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"k2_cheby {shape} {dtype}: not the unfused step's bits")
        del got, want
        field = np.prod(shape) * (4 if dtype == torch.float32 else 8)
        row = {
            "shape": list(shape), "dtype": _tag(dtype),
            "ms": graph_ms(lambda: sc.k2_cheby(d, res, xs, lvl.cx, lvl.cy,
                                               lvl.cz, lvl.diag, c1, c2,
                                               out=spare)),
            "bound_ms": 10 * field / PEAK_BYTES_S * 1e3,
            "init_ms": graph_ms(lambda: sc.k2_cheby_init(r, lvl.diag,
                                                         c0)),
            "init_bound_ms": 5 * field / PEAK_BYTES_S * 1e3,
            "unfused_ms": graph_ms(lambda: _cheby_unfused(
                lvl, r, d, x, c1, c2, False)),
            "unfused_bound_ms": 22 * field / PEAK_BYTES_S * 1e3,
        }
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        row["init_pct_of_bound"] = 100 * row["init_bound_ms"] / row["init_ms"]
        rows.append(row)
        log(f"times k2_cheby {shape} {row['dtype']}: {row['ms']:.4f} ms "
            f"graph, bound {row['bound_ms']:.4f} ms "
            f"({row['pct_of_bound']:.1f} %); init {row['init_ms']:.4f} ms, "
            f"bound {row['init_bound_ms']:.4f} ms "
            f"({row['init_pct_of_bound']:.1f} %); unfused seven launches "
            f"{row['unfused_ms']:.4f} ms (bound {row['unfused_bound_ms']:.4f})")
        del r, x, d, res, xs, spare
    log("k2_cheby " + json.dumps(rows))
    return rows


def _cheby_timing_levels(mg, mask):
    """The levels ``_times_k2_cheby`` times: the cycle's coarsest in
    float32 and float64 (128^3 at 512^3), and the coarsest of the cycle
    on the mask's first 128^3 (32^3) in float32."""
    from openimpala_tpu_torch.ops.stencil import make_tortuosity_system
    from openimpala_tpu_torch.solve.preconditioners import ConductanceLevel
    from openimpala_tpu_torch.solve.refine import make_precond

    lc = mg.levels[-1]
    lc64 = ConductanceLevel(*(t.double() for t in (lc.diag, lc.cx, lc.cy,
                                                   lc.cz)))
    crop = mask[:128, :128, :128].contiguous()
    small = make_precond(make_tortuosity_system(crop, 0, -1.0, 1.0,
                                                dtype=torch.float32),
                         "auto").levels[-1]
    return [lc, lc64, small]


def _k3_fns(lvl, x, r):
    """K3 on one smoothed-aggregation level."""
    from openimpala_tpu_torch.ops import offset as po
    from openimpala_tpu_torch.ops import offset_cuda as oc

    pk, offs, nn = lvl.packed, lvl.offsets, lvl.nn
    shape = tuple(lvl.diag.shape)
    return {
        "k3_apply_f32": (
            lambda: oc.k3_offset("apply", x, None, pk, offs),
            lambda: po.offset_apply_plain(x, pk, offs), shape),
        "k3_apply_prefix_f32": (
            lambda: oc.k3_offset("apply", x, None, pk, offs, n_taps=nn),
            lambda: po.offset_apply_plain(x, pk, offs, n_taps=nn), shape),
        "k3_resid_f32": (
            lambda: oc.k3_offset("resid", x, r, pk, offs),
            lambda: po.offset_resid_plain(x, r, pk, offs), shape),
        "k3_sweep_f32": (
            lambda: oc.k3_offset("sweep", x, r, pk, offs, omega=0.9),
            lambda: po.offset_sweep_plain(x, r, pk, offs, 0.9), shape),
    }


def _k3_levels(chk, mg, gen, run, fns, cost):
    """K3 on every level of the ``sa`` path's hierarchy: each mode the run
    launched at that level's extent is held against its plain form on the
    level's own packed coefficients and timed there.  Adds level 1's calls
    to ``fns`` and its per-cell cost to ``cost`` (the headline: level 1
    holds 7/8 of the coarse cells); returns name -> one record per level
    with the run's launches at that extent."""
    at = run["at"]
    shapes = {tuple(l.diag.shape) for l in mg.levels}  # each half the last
    stray = sorted(k for k in at
                   if k[0].startswith("k3_") and k[1] not in shapes)
    require(not stray, f"main[sa]: K3 ran at extents of no level: {stray}")
    per_level = {name: [] for name in _K3}
    for li, lvl in enumerate(mg.levels):
        pk, shape = lvl.packed, tuple(lvl.diag.shape)
        csize, cells = pk.element_size(), float(np.prod(shape))
        dims = "x".join(map(str, shape))
        log(f"times [sa] level {li + 1}: {dims} taps {len(lvl.offsets)} "
            f"nn {lvl.nn} {pk.dtype} {pk.numel() * csize / 1e6:.1f} MB")
        x, r = check_k3(chk, lvl, gen, f"main[sa] level {li + 1} {dims} "
                        f"{len(lvl.offsets)} taps nn {lvl.nn}",
                        (torch.float32,))
        lfns = _k3_fns(lvl, x, r)
        for name in _K3:
            taps = lvl.nn if "prefix" in name else len(lvl.offsets)
            bpc, fpc = k3_cost(name, taps, csize, 4)
            if li == 0:
                fns[name], cost[name] = lfns[name], (bpc, fpc)
            n = at.get((name, shape), 0)
            if n == 0:
                continue
            kfn, pfn, _ = lfns[name]
            rec = {"level": li + 1, "shape": list(shape), "taps": taps,
                   "launches": n, "ms": graph_ms(kfn),
                   "plain_ms": cuda_ms(pfn, 3, warmup=1),
                   "bound_ms": bpc * cells / PEAK_BYTES_S * 1e3}
            per_level[name].append(rec)
            log(f"times {name} [sa] level {li + 1} {dims} {taps} taps: "
                f"{rec['ms']:.4f} ms graph, plain {rec['plain_ms']:.3f} ms, "
                f"bound {rec['bound_ms']:.4f} ms, launches {n}")
    for name, recs in per_level.items():
        total = sum(v["launches"] for v in recs)
        require(total == run["counts"].get(name, 0),
                f"main[sa]: {name} launched {run['counts'].get(name, 0)} "
                f"times, {total} of them on a level")
    return per_level


_K1_MODE = {"k1_matvec_dot_f32": ("matvec_dot", torch.float32),
            "k1_matvec_f32": ("matvec", torch.float32),
            "k1_resid_f32": ("resid", torch.float32),
            "k1_sweep_f32": ("sweep", torch.float32),
            "k1_restrict_f32": ("restrict", torch.float32),
            "k1_matvec_f64": ("matvec", torch.float64)}


def _k1_levels(chk, mg, gen, run):
    """K1 on every level of the ``mg`` path's hierarchy: each mode the run
    launched at that level's extent is held against its plain form on the
    level's own packed code and timed there, with the route it took, the
    general route's time beside it and ``k1_cost``'s bound.  Returns name
    -> one record per level with the run's launches at that extent."""
    routes = run["routes"]
    per_level = {name: [] for name in _K1_MODE}
    for li, lvl in enumerate(mg.levels):
        shape = tuple(lvl.code.shape)
        dims = "x".join(map(str, shape))
        codes = sorted({float(v) for v in lvl.code.float().unique()})
        names = sorted({k[0] for k in routes if k[2] == shape})
        log(f"times [mg] level {li}: {dims} codes {codes[:3]}..{codes[-1]} "
            f"({len(codes)} values), K1 launched: {names}")
        modes = [_K1_MODE[k][0] for k in names if k.endswith("_f32")]
        x, r = check_k1(chk, lvl, gen, torch.float32,
                        f"main[mg] level {li} {dims}", modes=modes)
        fns = _k1_fns(lvl, x, r)
        general = _k1_fns(lvl, x, r, route="general")
        if "k1_matvec_f64" in names:
            chk.close("k1_matvec_f64", fns["k1_matvec_f64"][0](),
                      fns["k1_matvec_f64"][1](), torch.float64,
                      f"main[mg] level {li} {dims}")
        for name in names:
            took = sorted({k[1] for k in routes
                           if k[0] == name and k[2] == shape})
            require(len(took) == 1,
                    f"main[mg]: {name} at {dims} took routes {took}")
            mode, dtype = _K1_MODE[name]
            nbytes, flops = k1_cost(mode, shape, dtype)
            kfn, pfn, _ = fns[name]
            rec = {"level": li, "shape": list(shape), "route": took[0],
                   "launches": sum(v for k, v in routes.items()
                                   if k[0] == name and k[2] == shape),
                   "ms": graph_ms(kfn), "plain_ms": cuda_ms(pfn, 3, warmup=1),
                   "bound_ms": max(nbytes / PEAK_BYTES_S,
                                   flops / PEAK_FLOPS_S[dtype]) * 1e3}
            rec["general_route_ms"] = (rec["ms"] if took[0] == "general"
                                       else graph_ms(general[name][0]))
            per_level[name].append(rec)
            log(f"times {name} [mg] level {li} {dims}: {rec['ms']:.4f} ms "
                f"graph ({took[0]} route; general {rec['general_route_ms']:.4f}"
                f" ms), plain {rec['plain_ms']:.3f} ms, bound "
                f"{rec['bound_ms']:.4f} ms, launches {rec['launches']}")
        del x, r, fns, general
    for name, recs in per_level.items():
        total = sum(v["launches"] for v in recs)
        require(total == run["counts"].get(name, 0),
                f"main[mg]: {name} launched {run['counts'].get(name, 0)} "
                f"times, {total} of them on a level")
    return {k: v for k, v in per_level.items() if v}


def _restricted_fns(x, diag, free, w, per, k5: bool):
    """K4's three counters (and K5 where the input allows it) on one
    (diag, free): name -> (kernel call, plain call, shape)."""
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    shape = tuple(x.shape)
    x64, d64 = x.double(), diag.double()

    def plain():
        return st.apply_restricted_plain(x, diag, free, w, per)

    fns = {
        "k4_matvec_dot_f32": (
            lambda: sc.k4_matvec(x, diag, free, w, per, with_dot=True),
            lambda: st.apply_restricted_with_dot_plain(x, diag, free, w, per),
            shape),
        "k4_matvec_f32": (
            lambda: sc.k4_matvec(x, diag, free, w, per), plain, shape),
        "k4_matvec_f64": (
            lambda: sc.k4_matvec(x64, d64, free, w, per),
            lambda: st.apply_restricted_plain(x64, d64, free, w, per), shape),
    }
    if k5:
        fns["k5_matvec_f32"] = (
            lambda: sc.k5_matvec_stream(x, diag, free, w, per), plain, shape)
    return fns


def _time_path_kernels(by_path, label, names, fns, run, cost=None,
                       levels=None, general=None):
    """Time each of a path's kernels (graph, eager, plain) and file the
    record under ``by_path[name][label]``.  ``general``: K1's calls forced
    onto the general route, timed beside the route the rule chose.
    ``levels``: name -> the per-level records of a hierarchy (``_k3_levels``,
    ``_k1_levels``); ``cost``: name -> (bytes, flops) per cell where the run
    sets them."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    it = run["iterations"]
    for name in names:
        kfn, pfn, kshape = fns[name]
        n = run["counts"].get(name, 0)
        before = dict(sc.launches_route)
        t = {"launches": n, "launches_per_pcg_iter": n / it,
             "shape": list(kshape), "ms": graph_ms(kfn),
             "ms_eager": cuda_ms(kfn, 20),
             "plain_ms": cuda_ms(pfn, 3, warmup=1)}
        if general and name in general:
            took = sorted(k[1] for k, v in sc.launches_route.items()
                          if k[0] == name and v != before.get(k, 0))
            require(len(took) == 1, f"times {name} [{label}]: routes {took}")
            t["k1_route"] = took[0]
            t["general_route_ms"] = graph_ms(general[name][0])
        if cost and name in cost:
            t["bytes_per_cell"], t["flops_per_cell"] = cost[name]
        if levels and name in levels:
            lv = levels[name]
            t["levels"] = lv
            t["launches_at_shape"] = sum(v["launches"] for v in lv
                                         if v["shape"] == list(kshape))
            t["ms_all_launches"] = sum(v["ms"] * v["launches"] for v in lv)
            t["bound_ms_all_launches"] = sum(
                v["bound_ms"] * v["launches"] for v in lv)
        by_path[name][label] = t
        log(f"times {name} [{label}] {kshape}: {t['ms']:.4f} ms graph, "
            f"{t['ms_eager']:.4f} ms eager, plain {t['plain_ms']:.3f} ms;"
            f" launches {n} ({t['launches_per_pcg_iter']:.2f}/iter)"
            + (f"; {t['k1_route']} route, general route "
               f"{t['general_route_ms']:.4f} ms" if "k1_route" in t else ""))
        if "levels" in t:
            log(f"times {name} [{label}] all {n} launches, each at its "
                f"level's time: {t['ms_all_launches']:.1f} ms, bound "
                f"{t['bound_ms_all_launches']:.1f} ms")


def _k4_beside_k5(chk, M, x, case):
    """K5 and K4 (full diag, with the dot, a scalar diag, float64) on one
    (diag, free), each held against the plain form and timed from a CUDA
    graph.  The scalar is the system's largest diagonal entry: the same
    bytes as any scalar."""
    from openimpala_tpu_torch.ops import stencil_cuda as sc

    w, per = M.w, M.periodic
    check_restricted(chk, x, M.diag, M.free, w, per, case)
    fns = _restricted_fns(x, M.diag, M.free, w, per, k5=True)
    scalar = M.diag.max()
    cells = float(np.prod(M.diag.shape))
    beside = {
        "shape": list(M.diag.shape),
        "k5_ms": graph_ms(fns["k5_matvec_f32"][0]),
        "k4_full_diag_ms": graph_ms(fns["k4_matvec_f32"][0]),
        "k4_with_dot_ms": graph_ms(fns["k4_matvec_dot_f32"][0]),
        "k4_scalar_diag_ms": graph_ms(
            lambda: sc.k4_matvec(x, scalar, M.free, w, per)),
        "k4_f64_full_diag_ms": graph_ms(fns["k4_matvec_f64"][0]),
        "plain_ms": cuda_ms(fns["k5_matvec_f32"][1], 3, warmup=1),
        "full_diag_bound_ms": 13.0 * cells / PEAK_BYTES_S * 1e3,
        "scalar_diag_bound_ms": 9.0 * cells / PEAK_BYTES_S * 1e3,
        "f64_full_diag_bound_ms": 25.0 * cells / PEAK_BYTES_S * 1e3,
    }
    log(f"times K4 beside K5 [{case}]: " + json.dumps(
        {k: round(v, 4) if isinstance(v, float) else v
         for k, v in beside.items()}))
    return fns, beside


def _times_cheby(chk, by_path, label, system, M, gen, runs, expect):
    """K5 on the ``cheby`` path's own (diag, free), with K4 beside it on
    the same input; then the two side by side on the default path's
    full-size system, where the ``cheby`` path ran on a smaller volume."""
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.ops.stencil import make_tortuosity_system
    from openimpala_tpu_torch.solve.preconditioners import (
        ChebyshevPreconditioner)

    w, per = M.w, M.periodic
    dims = "x".join(map(str, M.diag.shape))
    case = f"main[{label}] (diag, free) {dims}"
    x, r = check_k1(chk, system, gen, torch.float32, case,
                    modes=("matvec_dot", "matvec"))
    x64 = x.double()
    chk.close("k1_matvec_f64",
              sc.k1_stencil("matvec", x64, None, system.code, w, per),
              st.apply_code_plain(x64, system.code, w, per), torch.float64,
              case)
    del x64
    fns = _k1_fns(system, x, r)
    k45, beside = _k4_beside_k5(chk, M, x, case)
    fns.update(k45)
    _time_path_kernels(by_path, label, expect, fns, runs[label],
                       general=_k1_fns(system, x, r, route="general"))
    rec = by_path["k5_matvec_f32"][label]
    rec["k4_on_the_same_input"] = beside
    full = runs["iso"]["mask"]
    if full.shape != tuple(M.diag.shape):
        del fns, k45, x, r
        torch.cuda.empty_cache()
        big = make_tortuosity_system(full, 0, -1.0, 1.0,
                                     dtype=torch.float32)
        Mb = ChebyshevPreconditioner.from_system(big)
        xb = torch.where(Mb.free, torch.randn(
            full.shape, generator=gen, dtype=torch.float32,
            device=M.diag.device), 0.0)
        rec["side_by_side_full_size"] = _k4_beside_k5(
            chk, Mb, xb, "main[iso] (diag, free) "
            + "x".join(map(str, full.shape)))[1]


def _times_rev(chk, by_path, label, vol, run, gen, expect):
    """K4 on the ``rev`` path's own batch: the crops the run drew, their
    (diag, free) as ``_make_precond`` holds them, 64 lanes."""
    from openimpala_tpu_torch.ops.stencil import make_cell_problem_system
    from openimpala_tpu_torch.solve.batched import _make_precond

    dev = torch.device("cuda")
    crops = np.stack([
        vol[s.seed[0]:s.seed[0] + s.actual_size[0],
            s.seed[1]:s.seed[1] + s.actual_size[1],
            s.seed[2]:s.seed[2] + s.actual_size[2]]
        for s in run["samples"]])
    masks = torch.from_numpy(crops == 1).to(dev)
    systems = make_cell_problem_system(masks, 0, dtype=torch.float32)
    M = _make_precond(systems, systems.r0_b, "cheby", CHEBY_DEGREE_BATCHED)
    x = torch.where(M.free, torch.randn(masks.shape, generator=gen,
                                        dtype=torch.float32, device=dev), 0.0)
    case = f"main[{label}] batch " + "x".join(map(str, masks.shape))
    check_restricted(chk, x, M.diag, M.free, M.w, M.periodic, case)
    check_restricted(chk, x.double(), M.diag.double(), M.free, M.w,
                     M.periodic, case)
    fns = _restricted_fns(x, M.diag, M.free, M.w, M.periodic, k5=False)
    _time_path_kernels(by_path, label, expect, fns, run)


def phase_times(chk, vol, seed, runs):
    """For each main path, hold its kernels against their plain versions on
    that path's own system and coarse levels, then time them: the kernel
    from a CUDA graph (``ms``) and back to back from the host
    (``ms_eager``), the plain version with CUDA events."""
    from openimpala_tpu_torch.ops import stencil as st
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.ops.stencil import (
        make_cell_problem_system, make_tortuosity_system)
    from openimpala_tpu_torch.solve.refine import make_precond

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # device-to-device copy rate, for reading the bound against this card
    big = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=dev)
    copy_ms = cuda_ms(lambda: big.clone(), 10)
    copy_gbs = 2 * big.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del big
    log(f"times: device copy {copy_gbs:.1f} GB/s (read+write)")

    by_path = {name: {} for name in PATH_KERNELS}
    for label, (kind, dx, precond, opts, expect) in PATHS.items():
        if kind == "rev":
            _times_rev(chk, by_path, label, vol, runs[label], gen, expect)
            torch.cuda.empty_cache()
            continue
        if kind == "deff":  # the periodic cell problem on the pore mask
            active = torch.from_numpy(vol == 1).to(dev)
            system = make_cell_problem_system(active, 0, dx=dx,
                                              dtype=torch.float32)
        else:  # the run's percolation mask, or iso's on the same volume
            active = runs[label].get("mask", runs["iso"]["mask"])
            system = make_tortuosity_system(active, 0, -1.0, 1.0, dx=dx,
                                            dtype=torch.float32)
        del active
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg = make_precond(system, precond, opts)
        torch.cuda.synchronize()
        log(f"times [{label}]: hierarchy rebuilt in "
            f"{time.perf_counter() - t0:.3f} s")
        if precond == "cheby":
            _times_cheby(chk, by_path, label, system, mg, gen, runs, expect)
            del system, mg
            torch.cuda.empty_cache()
            continue
        code, w, per = system.code, system.w, system.periodic
        case = f"main[{label}] system " + "x".join(map(str, code.shape))
        modes = [m for m in ("matvec_dot", "matvec", "resid", "sweep",
                             "restrict") if f"k1_{m}_f32" in expect]
        x, r = check_k1(chk, system, gen, torch.float32, case, modes=modes)
        x64 = x.double()
        chk.close("k1_matvec_f64",
                  sc.k1_stencil("matvec", x64, None, code, w, per),
                  st.apply_code_plain(x64, code, w, per), torch.float64, case)
        del x64
        fns = _k1_fns(system, x, r)
        cost = {}  # name -> (bytes, flops) per cell, where the run sets them
        levels = None
        if precond == "sa":
            levels = _k3_levels(chk, mg, gen, runs[label], fns, cost)
        elif precond == "mg":
            levels = _k1_levels(chk, mg, gen, runs[label])
        else:
            k2_levels = [(lvl,) + check_k2(chk, lvl, gen,
                                           f"main[{label}] level {li + 1} "
                                           + "x".join(map(str,
                                                          lvl.diag.shape)))
                         for li, lvl in enumerate(mg.levels)]
            fns.update(_k2_fns(k2_levels))
            del k2_levels
            if label == "iso":
                cheby_rows = _times_k2_cheby(
                    _cheby_timing_levels(mg, runs["iso"]["mask"]), seed + 2)
        _time_path_kernels(by_path, label, expect, fns, runs[label], cost,
                           levels,
                           general=_k1_fns(system, x, r, route="general"))
        del system, mg, fns, x, r
        torch.cuda.empty_cache()

    kernels = []
    for name, (src, tpu, bpc, fpc, dtype) in PATH_KERNELS.items():
        paths = by_path[name]
        # the headline numbers come from the path where it does most work
        # (launches at the timed shape times its cells)
        main_label = max(paths, key=lambda p: paths[p].get(
            "launches_at_shape", paths[p]["launches"])
            * float(np.prod(paths[p]["shape"])))
        t = paths[main_label]
        if bpc is None:  # K3: set by the taps of the level this run built
            bpc, fpc = t["bytes_per_cell"], t["flops_per_cell"]
        cells = float(np.prod(t["shape"]))
        bytes_ms = bpc * cells / PEAK_BYTES_S * 1e3
        ops_ms = fpc * cells / PEAK_FLOPS_S[dtype] * 1e3
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(p["launches"] for p in paths.values()),
            "max_abs_err": chk.max_err.get(name, None),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            # on the ranks' slabs, flow-through and periodic (sharded)
            "slab_max_abs_err": chk.max_err.get(name + ".slab"),
            "timed_on": main_label, "shape": t["shape"],
            "ms_eager": t["ms_eager"], "paths": paths,
        }
        if "k1_route" in t:
            entry["k1_route"] = t["k1_route"]
            entry["general_route_ms"] = t["general_route_ms"]
        if name == "k2_cheby_f32":
            entry["fused_and_unfused"] = cheby_rows
        kernels.append(entry)
        log(f"times {name}: {entry['ms']:.4f} ms on {main_label} "
            f"{tuple(t['shape'])}, bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']} ({entry['bound_ms'] / entry['ms']:.1%} of "
            f"bound); launches " + json.dumps(
                {p: v["launches"] for p, v in paths.items()})
            + (f"; {t['k1_route']} route, general route "
               f"{t['general_route_ms']:.4f} ms" if "k1_route" in t else ""))
    return kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512,
                    help="edge of the main-path volume (default 512; a "
                         "small one makes a short first call after a "
                         "kernel change)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import shutil
    import tempfile

    _RAW["dir"] = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return _main(args, t_start)
    finally:
        shutil.rmtree(_RAW.pop("dir"), ignore_errors=True)
        _RAW.clear()


def _main(args, t_start):
    # every kernel is built and loaded in a thread while the volume is made
    from openimpala_tpu_torch.ops import stencil_cuda as sc
    from openimpala_tpu_torch.solve import warmup

    warm = warmup.SolverWarmup(tuple(sc.SOURCES), torch.device("cuda"))
    chk = Checker()
    t0 = time.perf_counter()
    vol = make_blobs(args.n, 0.4, SEED)
    log(f"volume {args.n}^3 blobs porosity 0.4 seed {SEED}: "
        f"{time.perf_counter() - t0:.1f} s, pore fraction {vol.mean():.4f}")
    t0 = _phase_done("volume", t_start)
    try:
        phase_card(warm)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    t0 = _phase_done("card", t0)
    # the host and native fills of the perc phase run in worker threads
    # while the card checks its kernels (the labelling and the BFS run in
    # native code that releases the interpreter lock); the pool ends with
    # this block
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        host_jobs = {d: pool.submit(_host_fill, vol, d) for d in (0, 1, 2)}
        host_jobs["native"] = pool.submit(_host_fill, vol, 0, "native")
        try:
            phase_kernels(chk, SEED)
            t0 = _phase_done("kernels", t0)
            perc = phase_perc(vol, args.n, host_jobs)
            t0 = _phase_done("perc", t0)
            runs = phase_main(vol, args.n, perc["mask_x"])
            del perc
            t0 = _phase_done("main", t0)
            sharded = collections.Counter(
                phase_sharded(chk, vol, args.n, runs))
            sharded.update(phase_sharded_cli(_RAW["dir"]))
            t0 = _phase_done("sharded", t0)
            phase_graph(SEED)
            t0 = _phase_done("graph", t0)
            phase_rules(SEED)
            t0 = _phase_done("rules", t0)
            phase_parity(SEED)
            t0 = _phase_done("parity", t0)
            torch.cuda.empty_cache()
            kernels = phase_times(chk, vol, SEED, runs)
            _phase_done("times", t0)
            for entry in kernels:  # the sharded solve's launches, all ranks
                if sharded.get(entry["name"]):
                    entry["launches"] += sharded[entry["name"]]
                    entry["sharded_launches"] = sharded[entry["name"]]
        except SmokeFailure as e:
            print(f"chip_smoke FAILED: {e}", file=sys.stderr)
            return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
