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
  recurrence, ``solve/cg.py``);
* every vector update is one op on the stacked lanes, and the host reads
  one (3, L) probe for all lanes after every iteration, and stops when
  every lane is done (on CUDA pipelined, as the mono loop's reads are:
  ``utils/graphs.py::iterate``);
* the operator apply is L calls of the shared system's K1 matvec+dot, and
  the preconditioner, built once from ``base()``, is applied per lane;
* iterative refinement (``solve/refine.py``'s policy, lane-wise) runs all
  lanes through one float64 outer residual per round;
* on CUDA the iterations of every round of a solve replay one CUDA
  graph (``utils/graphs.py``), as the mono loop's do.

On X slabs (systems built with a ``mesh``) every lane's dot products and
norms are summed over the ranks (``Mesh.allsum``, the same bits on every
rank, so every rank reads the same probe and takes the same branch), each
lane's preconditioner is the slab cycle (``solve/slab_mg.py``), and the
iterations run eagerly, as the mono loop's do there.

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
from ..utils import graphs
from ..utils.common import device_hbm_limit
from ..utils.profiling import phase_timer
from .cg import SolveResult, _probe

_VOL = (1, 2, 3)  # the volume axes of an (L, X, Y, Z) stack


def _lane_dot(a, b, mesh=None):
    """Per-lane <a_i, b_i>; under a ``mesh``, summed over the ranks'
    slabs."""
    d = torch.sum(a * b, dim=_VOL)
    return d if mesh is None else mesh.allsum(d)


def _bcast(v, ndim: int):
    return v.reshape(v.shape + (1,) * (ndim - 1))


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


def _lanes_step(lsys, precond, state, denom, eps):
    """One lockstep PCG iteration over all lanes, written into the state
    tensors in place: the lane-wise top-form recurrence of ``solve/cg.py::
    _cg_step``.  A lane that is done pins alpha to 0 and becomes a fixed
    point; only its counters are gated."""
    z, r, p, rz_prev, it, rel, done = state
    L = r.shape[0]
    ndim = r.dim()
    y = r if precond is None else torch.stack(
        [precond(r[i]) for i in range(L)])
    rz = _lane_dot(r, y, lsys.mesh)
    beta = torch.where((rz_prev > 0) & ~done,
                       rz / torch.where(rz_prev > 0, rz_prev, 1.0), 0.0)
    torch.add(y, _bcast(beta, ndim) * p, out=p)
    ap, pap = lsys.apply_with_dot(p)
    ok = (pap > 0) & ~done
    alpha = torch.where(ok, rz / torch.where(pap > 0, pap, 1.0), 0.0)
    torch.add(z, _bcast(alpha, ndim) * p, out=z)
    torch.sub(r, _bcast(alpha, ndim) * ap, out=r)
    rel2 = torch.sqrt(_lane_dot(r, r, lsys.mesh)) / denom
    done2 = done | (rel2 <= eps) | (pap <= 0)
    rz_prev.copy_(rz)
    it.copy_(torch.where(done, it, it + 1))
    rel.copy_(torch.where(done, rel, rel2))
    done.copy_(done2)


def cg_lanes(lsys: LaneSystem, r0, denom, eps, maxiter: int, precond,
             verbose: int = 0, history=None, _graph=None) -> SolveResult:
    """Lockstep PCG on ``(L, ...)`` state, one host read of the (3, L)
    probe per iteration, stopped when every lane is done or the largest
    lane count reaches ``maxiter`` (the mono loop's rule, ``solve/cg.py::
    _cg_loop``), z0 = 0.  ``denom`` is per lane (a zero one falls back to
    ``||r0_i||``, then to 1); ``precond`` None is the identity.  Returns a
    ``SolveResult`` whose iterations, rel_res and converged are (L,)
    tensors.  ``_graph``: as in ``solve/cg.py::_cg_loop``."""
    L = r0.shape[0]
    dev = r0.device
    mesh = lsys.mesh
    denom = torch.as_tensor(denom, dtype=r0.dtype).to(dev)
    norm0 = torch.sqrt(_lane_dot(r0, r0, mesh))
    denom = torch.where(denom > 0, denom, norm0)
    denom = torch.where(denom > 0, denom, 1.0)
    rel0 = norm0 / denom
    state = (torch.zeros_like(r0), r0.clone(), torch.zeros_like(r0),
             torch.zeros((L,), dtype=r0.dtype, device=dev),
             torch.zeros((L,), dtype=torch.int32, device=dev), rel0,
             rel0 <= eps)

    def stop(values):
        its, dones, rels_v = values
        it = int(max(its))  # the largest lane count
        if verbose >= 2:
            rels = ", ".join(f"{v:.3e}" for v in rels_v)
            print(f"    cg-lanes it={it:5d}  rel_res=[{rels}]")
        if history is not None:
            history.record_inner(it, rels_v)
        return all(d > 0 for d in dones)

    with graphs.solve_graph(dev, _graph, mesh) as holder:
        if holder:
            holder.load(("lanes", id(lsys), id(precond)),
                        lambda *a: _lanes_step(lsys, precond, a[:7], a[7],
                                               a[8]),
                        lambda *a: _probe(*a[4:7]),
                        state, (denom, torch.full((), eps, dtype=r0.dtype,
                                                  device=dev)))
        if not bool(state[6].all()):  # every r0 already meets eps
            graphs.iterate(
                holder,
                lambda: _lanes_step(lsys, precond, state, denom, eps),
                lambda: _probe(*state[4:])[0], maxiter, stop)
        z, r, p, rz, it, rel, done = holder.state if holder else state
        if holder and holder is _graph:
            # a shared holder's buffers: the next call overwrites them
            z, it, rel = z.clone(), it.clone(), rel.clone()
    return SolveResult(z=z, iterations=it, rel_res=rel, converged=rel <= eps)


def _lanes_stalled(rel, prev_rel, eps) -> bool:
    """Refinement stall: only UNCONVERGED lanes count as progress, so a
    lane already at rel <= eps does not keep the loop alive while the rest
    plateau at the float32 floor (mono: refine.py's ``rel >= prev_rel *
    0.5`` break).  Never stalls on the first round (prev_rel = inf)."""
    improved = (rel < prev_rel * 0.5) & ~(rel <= eps)
    return bool(np.isfinite(prev_rel).all() and not improved.any())


# Glue steps, lane-wise mirrors of refine.py's ``_outer_residual``,
# ``_round0_estimate``, ``_scale_inner_rhs`` and ``_accumulate``.

def _outer_residual_lanes(lsys, x_outer, outer_dtype):
    """Per-lane ``free * (b - A x)`` with the system cast to
    ``outer_dtype``, and the per-lane norms."""
    rs = lsys.astype(outer_dtype).initial_residual(x_outer)
    return rs, torch.sqrt(_lane_dot(rs, rs, lsys.mesh))


def _round0_estimate_lanes(lsys, z_total):
    """Round-0 residuals in the Krylov (storage) dtype and their float64
    norms (refine.py: summed in float32)."""
    r_hi = lsys.initial_residual(z_total.to(lsys.r0_b.dtype))
    s = torch.sum(r_hi.to(torch.float32) ** 2, dim=_VOL)
    if lsys.mesh is not None:
        s = lsys.mesh.allsum(s)
    scale = torch.sqrt(s.to(torch.float64))
    return r_hi, scale


def _scale_inner_rhs_lanes(r_hi, scale, live, inner_dtype):
    """Per-lane normalised inner RHS in the Krylov dtype; converged lanes
    are zeroed, so they ride along as zero systems (alpha pins to 0)."""
    r_lo = (r_hi / _bcast(torch.where(scale > 0, scale, 1.0),
                          r_hi.dim()).to(r_hi.dtype)).to(inner_dtype)
    return r_lo * _bcast(live.to(r_lo.dtype), r_lo.dim())


def _accumulate_lanes(z_total, scale, z):
    return z_total + _bcast(scale, z_total.dim()) * z.to(z_total.dtype)


def solve_system_lanes(lsys: LaneSystem, eps: float, maxiter: int,
                       precond="none", inner_dtype=torch.float32,
                       inner_eps: float = 1e-5, max_refine_rounds: int = 8,
                       inner_round_cap: int = 5000,
                       outer_dtype=torch.float64, precond_opts=None,
                       verbose: int = 0, history=None, timings=None,
                       _graph=None):
    """Solve every lane to ``||b_i - A x_i|| / ||b_i|| <= eps`` with
    ``solve/refine.py::solve_system``'s mixed-precision refinement run in
    lockstep (one outer residual and one inner Krylov per round for all
    lanes), x0 = 0 for every lane (the cell problems' initial iterate,
    ``EffDiffFillMtx.F90:126``).  MIRROR: the policy (round-0 residual in
    the storage dtype with the 1e-3 guard, adaptive round tolerance from
    the worst lane, budget, stall break, final re-measure only when stale)
    is a lane-wise copy of solve_system; keep the two in sync.
    ``precond``: a name for ``make_precond`` or a built preconditioner,
    applied per lane.  Returns ``(x_full (L, ...), info)`` with per-lane
    (L,) iterations, rel_res and converged.  ``_graph``: as in
    ``solve/refine.py::solve_system``."""
    with graphs.solve_graph(lsys.code.device, _graph, lsys.mesh) as graph:
        return _solve_lanes(lsys, eps, maxiter, precond, inner_dtype,
                            inner_eps, max_refine_rounds, inner_round_cap,
                            outer_dtype, precond_opts, verbose, history,
                            timings, graph)


def _solve_lanes(lsys, eps, maxiter, precond, inner_dtype, inner_eps,
                 max_refine_rounds, inner_round_cap, outer_dtype,
                 precond_opts, verbose, history, timings, graph):
    from .refine import make_precond

    L = lsys.lanes
    dev = lsys.code.device
    storage_dtype = lsys.r0_b.dtype

    if inner_dtype is None or inner_dtype == outer_dtype:
        r0 = lsys.initial_residual(torch.zeros_like(lsys.r0_b))
        with phase_timer(None, "solve/hierarchy_build"):
            M = make_precond(lsys.base(), precond, precond_opts)
        with phase_timer(None, "solve/krylov"):
            res = cg_lanes(lsys, r0, lsys.b_norm, eps, maxiter, M,
                           verbose=verbose, history=history, _graph=graph)
        return lsys.assemble_solution(res.z), res

    if storage_dtype != inner_dtype:
        lsys = lsys.astype(inner_dtype)
    with phase_timer(timings, "solve/hierarchy_build", dev):
        M_lo = make_precond(lsys.base(), precond, precond_opts)
    # host vector: the denominators' only consumers are host-side
    denom = np.maximum(lsys.b_norm.double().cpu().numpy(), 0.0)
    denom = np.where(denom > 0, denom, 1.0)

    z_total = torch.zeros(lsys.r0_b.shape, dtype=outer_dtype, device=dev)
    total_iters = np.zeros(L, dtype=np.int64)
    rel = np.full(L, np.inf)
    prev_rel = np.full(L, np.inf)
    budget = int(maxiter)

    stale = True  # does rel reflect the current z_total?
    for round_i in range(int(max_refine_rounds)):
        with phase_timer(timings, "solve/outer_residual", dev):
            lo_first = round_i == 0
            if lo_first:
                r_hi, scale = _round0_estimate_lanes(lsys, z_total)
                rel = scale.cpu().numpy() / denom
                if (rel < 1e-3).any():  # too close to the f32 floor
                    lo_first = False
            if not lo_first:
                r_hi, scale = _outer_residual_lanes(lsys, z_total,
                                                    outer_dtype)
                rel = scale.cpu().numpy() / denom
        stale = False
        if verbose >= 2:
            rels = ", ".join(f"{v:.3e}" for v in rel)
            print(f"  refine round (lanes): outer rel_res=[{rels}]")
        if history is not None:
            history.record_outer(round_i, rel)
        if bool((rel <= eps).all()):
            break
        if _lanes_stalled(rel, prev_rel, eps):
            break  # no unconverged lane halved its residual this round
        if budget <= 0:
            break
        prev_rel = rel
        live = torch.from_numpy(~(rel <= eps)).to(dev)
        r_lo = _scale_inner_rhs_lanes(r_hi, scale, live, inner_dtype)
        del r_hi
        # adaptive round tolerance from the worst lane (0.3 margin)
        worst = float(rel.max())
        need = float(eps / worst) * 0.3 if worst > 0 else inner_eps
        round_eps = min(max(inner_eps, need), 0.099)
        with phase_timer(timings, "solve/inner_round", dev):
            if history is not None:
                history._base = int(total_iters.max())
            with phase_timer(None, "solve/krylov"):
                inner = cg_lanes(lsys, r_lo,
                                 torch.ones((L,), dtype=inner_dtype,
                                            device=dev),
                                 round_eps, min(budget, int(inner_round_cap)),
                                 M_lo, verbose=verbose, history=history,
                                 _graph=graph)
            del r_lo
            z_total = _accumulate_lanes(z_total, scale, inner.z)
            n_it = inner.iterations.cpu().numpy().astype(np.int64)
            total_iters += n_it
            budget -= int(n_it.max())
        stale = True

    if stale:
        _, scale = _outer_residual_lanes(lsys, z_total, outer_dtype)
        rel = scale.cpu().numpy() / denom
        if history is not None:
            history.record_outer(-1, rel)
    x_full = lsys.astype(outer_dtype).assemble_solution(z_total)
    info = SolveResult(z=z_total, iterations=tuple(int(v) for v in
                                                   total_iters),
                       rel_res=tuple(float(v) for v in rel),
                       converged=tuple(bool(v <= eps) for v in rel))
    return x_full, info


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
