"""Lockstep multi-RHS PCG for same-operator stencil systems (counterpart of
``openimpala_tpu/solve/lanes.py``).

The homogenisation path solves three periodic cell problems on one
operator; only the right-hand side carries the direction
(``ops/stencil.py::make_cell_problem_system``; reference
``EffDiffFillMtx.F90:42-264``).  Here the three solves advance in lockstep
as lanes of one solve:

* the state is ``(L, X, Y, Z)`` and alpha, beta, the residuals and the
  convergence flags are per-lane vectors (lane-wise PCG, not block CG: the
  lanes never couple, so each lane repeats the sequential solve's top-form
  recurrence);
* every vector update is one op on the stacked lanes, and the host reads
  one (3, L) probe for all lanes after every iteration, and stops when
  every lane is done;
* the operator apply is L calls of the shared system's K1 matvec+dot, and
  the preconditioner, built once from ``base()``, is applied per lane;
* iterative refinement runs all lanes through one float64 outer residual
  per round.

The step, the loop and the refinement rounds are the mono solve's
(``solve/cg.py::_cg_step``, ``_cg_loop``, ``solve/refine.py::
_solve_system``): a ``LaneSystem``'s lane axis decides where the two
differ, so on CUDA the lanes' iterations replay one CUDA graph per solve,
and on X slabs (systems built with a ``mesh``) every lane's dot products
and norms are summed over the ranks (``Mesh.allsum``, the same bits on
every rank), each lane's preconditioner is the slab cycle
(``solve/slab_mg.py``) and the iterations run eagerly, as the mono
loop's do.  This module keeps what only the lanes have: the lane system,
the refinement's stall rule, and when the lanes are taken.

Memory gate (``use_lanes``): lane state is L times the mono solve's; on
slabs each rank holds its share, on a device it may share with other
ranks.  On one CUDA card the lanes also have to pay (``lanes_pay``): they
save host reads and graph captures, not device time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.stencil import StencilSystem
from ..utils.common import device_hbm_limit
from .cg import SolveResult, _cg_loop


@dataclasses.dataclass(frozen=True)
class LaneSystem:
    """L restricted systems sharing one operator (code, w, periodic,
    x_forced); the per-lane data is the stacked RHS and its norms.  Mirrors
    ``ops.stencil.StencilSystem`` lane-wise."""

    code: torch.Tensor  # shared bf16 packed geometry
    x_forced: torch.Tensor  # shared forced values (0-d zero for cell problems)
    r0_b: torch.Tensor  # (L, X, Y, Z) per-lane restricted RHS
    b_norm: torch.Tensor  # (L,)
    w: tuple
    periodic: tuple
    # X slabs: the rank's Mesh and the code in K1's slab layout
    mesh: object = None
    code_halo: torch.Tensor = None

    @classmethod
    def from_systems(cls, systems):
        """Stack same-operator systems (the operator identity, equal code,
        w, periodic and x_forced, is the caller's contract); slab systems
        give a lane system on the same slabs."""
        base = systems[0]
        return cls(code=base.code, x_forced=base.x_forced,
                   r0_b=torch.stack([s.r0_b for s in systems]),
                   b_norm=torch.stack([s.b_norm for s in systems]),
                   w=base.w, periodic=base.periodic, mesh=base.mesh,
                   code_halo=base.code_halo)

    @property
    def lanes(self) -> int:
        return self.r0_b.shape[0]

    def base(self) -> StencilSystem:
        """Mono StencilSystem view (lane 0): the preconditioner's build and
        the shared-operator apply."""
        return StencilSystem(code=self.code, x_forced=self.x_forced,
                             r0_b=self.r0_b[0], b_norm=self.b_norm[0],
                             w=self.w, periodic=self.periodic,
                             mesh=self.mesh, code_halo=self.code_halo)

    def apply_with_dot(self, x):
        """``(A x_i, <x_i, A x_i>)`` for every lane: L calls of the base
        system's matvec with the fused dot (K1 on the card)."""
        mono = self.base()
        aps, paps = zip(*(mono.apply_with_dot(x[i])
                          for i in range(self.lanes)))
        return torch.stack(aps), torch.stack(paps)

    def initial_residual(self, x0):
        """Per-lane ``free * (b_i - A (x_forced + x0_i))``; ``x0`` is
        (L, X, Y, Z) on the free set."""
        mono = self.base()
        return torch.stack([
            torch.where(mono.free,
                        self.r0_b[i] - mono.apply(self.x_forced + x0[i]),
                        torch.zeros((), dtype=x0.dtype, device=x0.device))
            for i in range(self.lanes)])

    def assemble_solution(self, z):
        free = self.code > 0
        zero = torch.zeros((), dtype=z.dtype, device=z.device)
        return self.x_forced + torch.where(free, z, zero)

    def astype(self, dtype) -> "LaneSystem":
        return dataclasses.replace(
            self, x_forced=self.x_forced.to(dtype),
            r0_b=self.r0_b.to(dtype), b_norm=self.b_norm.to(dtype))


def cg_lanes(lsys: LaneSystem, r0, denom, eps, maxiter: int, precond,
             verbose: int = 0, history=None, _graph=None) -> SolveResult:
    """Lockstep PCG on ``(L, ...)`` state (``solve/cg.py::_cg_loop`` on a
    lane system), one host read of the (3, L) probe per iteration, stopped
    when every lane is done or the largest lane count reaches ``maxiter``,
    z0 = 0.  ``denom`` is per lane (a zero one falls back to ``||r0_i||``,
    then to 1); ``precond`` None is the identity.  Returns a
    ``SolveResult`` whose iterations, rel_res and converged are (L,)
    tensors.  ``_graph``: as in ``solve/cg.py::_cg_loop``."""
    return _cg_loop(lsys, r0, denom, eps, int(maxiter), precond,
                    verbose=verbose, history=history, _graph=_graph)


def _lanes_stalled(rel, prev_rel, eps) -> bool:
    """Refinement stall: only UNCONVERGED lanes count as progress, so a
    lane already at rel <= eps does not keep the loop alive while the rest
    plateau at the float32 floor (mono: refine.py's ``rel >= prev_rel *
    0.5`` break).  Never stalls on the first round (prev_rel = inf)."""
    improved = (rel < prev_rel * 0.5) & ~(rel <= eps)
    return bool(np.isfinite(prev_rel).all() and not improved.any())


def solve_system_lanes(lsys: LaneSystem, eps: float, maxiter: int,
                       precond="none", inner_dtype=torch.float32,
                       inner_eps: float = 1e-5, max_refine_rounds: int = 8,
                       inner_round_cap: int = 5000,
                       outer_dtype=torch.float64, precond_opts=None,
                       verbose: int = 0, history=None, timings=None,
                       _graph=None):
    """Solve every lane to ``||b_i - A x_i|| / ||b_i|| <= eps`` with
    ``solve/refine.py::solve_system``'s mixed-precision refinement run in
    lockstep (one outer residual and one inner PCG per round for all
    lanes; the round tolerance from the worst lane), x0 = 0 for every
    lane (the cell problems' initial iterate, ``EffDiffFillMtx.F90:126``).
    ``precond``: a name for ``make_precond`` or a built preconditioner,
    applied per lane.  Returns ``(x_full (L, ...), info)`` with per-lane
    iterations, rel_res and converged (tuples; (L,) tensors where
    ``inner_dtype`` disables refinement).  ``_graph``: as in
    ``solve/refine.py::solve_system``."""
    from .refine import solve_system  # refine.py imports this module

    return solve_system(lsys, None, eps, maxiter, "cg", precond,
                        inner_dtype, inner_eps, max_refine_rounds,
                        inner_round_cap, outer_dtype, precond_opts, verbose,
                        history, timings, _graph)


# The memory model of a lockstep solve, bytes per cell: ``lanes`` x (the
# Krylov fields in the inner dtype + the accumulator, the outer residual and
# the solution in the outer dtype) + what is shared (the phase, the masks,
# the packed operator, the hierarchy).  Measured on an H100 with
# ``torch.cuda.max_memory_allocated`` (scripts/torch_perc_lanes.py; PERF.md
# section 6): a forced three-lane solve peaks at 197.25 B per cell at
# 256^3 and at 512^3, the sequential loop at 108.25, so a lane costs 44.5 B
# (5 float32 + 3 float64 fields = 44) and the rest, 65.25 B, is shared.
LANE_FIELDS_INNER = 5
LANE_FIELDS_OUTER = 3
SHARED_BYTES_PER_CELL = 66
# the CPU reports no device memory: the JAX package's fallback budget
# (``fgmres._device_hbm_budget``, 6 GiB usable)
FALLBACK_LIMIT = 6 * 1024 ** 3 / 0.85


def lanes_bytes_per_cell(lanes: int, inner_bytes: int = 4,
                         outer_bytes: int = 8) -> float:
    return lanes * (LANE_FIELDS_INNER * inner_bytes
                    + LANE_FIELDS_OUTER * outer_bytes) + SHARED_BYTES_PER_CELL


def use_lanes(cells: int, lanes: int, method: str = "cg",
              inner_bytes: int = 4, outer_bytes: int = 8,
              device="cpu", mesh=None) -> bool:
    """Memory gate for the lockstep path: lanes engage where the model
    (``lanes_bytes_per_cell``) fits in 85 % of the device's memory
    (``utils.common.device_hbm_limit``), or of ``FALLBACK_LIMIT`` where
    the device reports none (the CPU).

    Under a ``mesh`` (``cells`` the global count) each rank holds
    ``cells / mesh.size`` of the volume, and its share of the device is
    the device's memory over the ranks that run on it (the JAX package's
    ``n_devices``, corrected for ranks that share a card: each of them
    sees the whole card in ``torch.cuda.mem_get_info``).  Every rank must
    call this; the answer is the same on every rank (lanes only where
    every rank's share holds them)."""
    if method not in ("cg", "pcg"):
        return False
    device = device if mesh is None else mesh.device
    limit = device_hbm_limit(device)
    if limit <= 0:
        limit = FALLBACK_LIMIT
    need = cells * lanes_bytes_per_cell(lanes, inner_bytes, outer_bytes)
    if mesh is None:
        return need < 0.85 * limit
    fits = need / mesh.size < 0.85 * limit / mesh.ranks_on_device()
    refused = mesh.allsum(torch.tensor(int(not fits), device=mesh.device))
    return int(refused) == 0


# ``lanes="auto"`` on one CUDA card: the lanes up to the largest volume at
# which they were faster.  Measured with scripts/torch_crossovers.py on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md, PR 13), make_blobs(n, 0.4, 0):
# medians of 11 alternating pairs, lanes against the sequential loop, ms,
# and the larger interquartile range: 32^3 94.3 / 107.5 (14.0), 48^3
# 81.8 / 99.2 (7.1), 64^3 82.4 / 92.3 (15.0), 80^3 96.8 / 102.4 (6.9),
# 96^3 94.4 / 112.4 (8.9), 128^3 113.8 / 132.2 (10.3): lower at every size,
# by more than the spread at 48^3, 96^3 and 128^3 (the lanes save two graph
# captures and two thirds of the probe reads, not device time).  Three
# pairs from 256^3 up: 348.3 / 355.1, 989.4 / 1011.0, 2355.3 / 2284.9 ms,
# ties within the spread, while the lanes' peak is 1.7 times the
# sequential loop's (512^3: 25.00 against 14.53 GB).
CUDA_LANES_MAX_CELLS = 128 ** 3


def lanes_pay(cells: int, device="cpu", mesh=None) -> bool:
    """Whether ``lanes="auto"`` may take the lanes for a volume of
    ``cells`` on ``device`` (the memory gate ``use_lanes`` decides after
    it): on one CUDA device up to ``CUDA_LANES_MAX_CELLS``; on the CPU and
    under a mesh always, which leaves the JAX package's rule, the memory
    gate alone (the CPU is where the port is held to the JAX package; on
    slabs nothing is measured yet)."""
    if mesh is not None or torch.device(device).type != "cuda":
        return True
    return cells <= CUDA_LANES_MAX_CELLS
