"""Mixed-precision iterative refinement (counterpart of
``openimpala_tpu/solve/refine.py``): float32 Krylov rounds inside a float64
outer residual loop,

    r = b - A x   (float64: K1 matvec in double on the card)
    solve A d = r (float32 PCG to the round's tolerance)
    x = x + d     (float64)

The policy matches the JAX package line for line: round-0 residual in the
storage dtype with the 1e-3 guard, adaptive round tolerance, stagnation
break, iteration budget, and the final re-measure only when the last round
left the residual stale.

On CUDA the PCG iterations of every round of a solve replay one CUDA graph
(``utils/graphs.py``): the round's tolerance enters it as a tensor, and
the graph and its pool are released when the solve returns.

On X slabs (a system with a ``mesh``) the outer residual's norms are
summed over the ranks, so every rank takes the same branch; the Krylov
solve (PCG or FGMRES) runs eagerly (``utils/graphs.py::chunk_graph``)
with every preconditioner in its slab form: the default cycle
(``solve/slab_mg.py``), ``"mg"`` (``SlabMultigridPreconditioner``),
``"sa"`` (``solve/slab_sa.py``), ``"cheby"`` (K5 on the padded slab),
Jacobi or none.

The lockstep lanes (``solve/lanes.py::solve_system_lanes``) run this
loop on a lane system: one outer residual and one inner PCG per round
for all lanes, with the differences the JAX package's ``lanes.py`` keeps
(``_solve_system``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import graphs
from ..utils.profiling import phase_timer
from . import lanes as lockstep
from .cg import SolveResult, _bcast, _lanes, _mesh, _vdot, cg
from .fgmres import fgmres
from .preconditioners import (
    ChebyshevPreconditioner,
    GalerkinMGPreconditioner,
    JacobiPreconditioner,
    MultigridPreconditioner,
)
from .sa import SAMGPreconditioner
from .slab_mg import SlabGalerkinMGPreconditioner
from .slab_sa import SlabSAMGPreconditioner


def _krylov(method: str, system, r0, denom, eps, maxiter, precond,
            refined: bool = True, verbose: int = 0, history=None,
            _graph=None):
    if _lanes(system):  # the lockstep lanes run PCG only (``use_lanes``)
        return lockstep.cg_lanes(system, r0, denom, eps, maxiter, precond,
                                 verbose=verbose, history=history,
                                 _graph=_graph)
    if method in ("cg", "pcg"):
        return cg(system, r0, denom, eps, maxiter, precond=precond,
                  verbose=verbose, history=history, _graph=_graph)
    if method in ("flexgmres", "gmres", "fgmres"):
        # the FGMRES plateau break is only safe where a refinement outer
        # loop exists to re-scale the residual and continue (``refined``)
        return fgmres(system, r0, denom, eps, maxiter, precond=precond,
                      stall_break=refined, verbose=verbose, history=history)
    raise ValueError(f"unknown Krylov method: {method}")


def _outer_residual(system, x_outer, outer_dtype):
    """free * (b - A x) with the system cast to ``outer_dtype``, and its
    norm (per lane on a lane system)."""
    r = system.astype(outer_dtype).initial_residual(x_outer)
    return r, torch.sqrt(_vdot(system, r, r))


def _round0_estimate(system, z_total):
    """Round-0 residual in the Krylov (storage) dtype and its float64 norm
    (summed in float32): the first residual is far above the float32 noise
    floor."""
    r_hi = system.initial_residual(z_total.to(system.r0_b.dtype))
    r32 = r_hi.to(torch.float32)
    return r_hi, torch.sqrt(_vdot(system, r32, r32).to(torch.float64))


def _scale_inner_rhs(r_hi, scale, inner_dtype):
    """Normalised inner-round RHS (r / ||r||) in the Krylov dtype."""
    return (r_hi / _bcast(torch.where(scale > 0, scale, 1.0), r_hi).to(
        r_hi.dtype)).to(inner_dtype)


def _accumulate(z_total, scale, z):
    """High-precision accumulation z_total + scale * z."""
    return z_total + _bcast(scale, z_total) * z.to(z_total.dtype)


def make_precond(sys_, precond, opts=None, method: str = "cg"):
    """``"auto"`` (= ``"gmg"``), ``"gmg"``, ``"mg"``, ``"sa"`` (=
    ``"samg"``), ``"cheby"`` (= ``"chebyshev"``), ``"jacobi"`` or
    ``"none"``; any other name raises.  A preconditioner that is already built (a callable
    ``r -> z``) is returned as it is.  A slab system (one with a ``mesh``)
    gets each one's slab form.  ``method`` (the Krylov method) is the JAX
    package's call shape and is not read: every preconditioner serves CG
    and FGMRES alike."""
    opts = opts or {}
    if precond is not None and not isinstance(precond, str):
        return precond
    if precond == "auto":
        precond = "gmg"
    if precond is None or precond == "none":
        return None
    if precond == "jacobi":
        return JacobiPreconditioner.from_system(sys_)
    slabs = _mesh(sys_) is not None
    if precond == "gmg":
        return (SlabGalerkinMGPreconditioner if slabs
                else GalerkinMGPreconditioner).from_system(sys_, **opts)
    if precond in ("sa", "samg"):
        return (SlabSAMGPreconditioner if slabs
                else SAMGPreconditioner).from_system(sys_, **opts)
    # the Chebyshev polynomial and "mg" take a slab system as it is
    if precond in ("cheby", "chebyshev"):
        return ChebyshevPreconditioner.from_system(sys_, **opts)
    if precond == "mg":
        return MultigridPreconditioner.from_system(sys_, **opts)
    raise ValueError(f"unknown preconditioner: {precond!r}")


def solve_system(system, x0_free, eps: float, maxiter: int,
                 method: str = "cg", precond="none",
                 inner_dtype=torch.float32, inner_eps: float = 1e-5,
                 max_refine_rounds: int = 8, inner_round_cap: int = 5000,
                 outer_dtype=torch.float64, precond_opts=None,
                 verbose: int = 0, history=None, timings=None,
                 _graph=None):
    """Solve the StencilSystem to ``||b - A x|| / ||b_full|| <= eps``
    (a ``LaneSystem`` from ``x0_free`` None: every lane to its own).

    The system should be stored in ``inner_dtype`` (or the final dtype when
    ``inner_dtype is None``, which disables refinement).  Returns
    ``(x_full, info)`` with ``x_full`` in ``outer_dtype`` and
    ``info.rel_res`` the full-system relative residual measured in
    ``outer_dtype``.  ``timings``: optional dict that collects the wall
    seconds of the hierarchy build, outer residuals and inner rounds.
    ``_graph``: see ``solve/cg.py::_cg_loop`` (None: one CUDA
    graph for the whole solve on CUDA).
    """
    with graphs.solve_graph(system.code.device, _graph,
                            _mesh(system)) as graph:
        return _solve_system(system, x0_free, eps, maxiter, method, precond,
                             inner_dtype, inner_eps, max_refine_rounds,
                             inner_round_cap, outer_dtype, precond_opts,
                             verbose, history, timings, graph)


def _solve_system(system, x0_free, eps, maxiter, method, precond,
                  inner_dtype, inner_eps, max_refine_rounds, inner_round_cap,
                  outer_dtype, precond_opts, verbose, history, timings,
                  graph):
    """The refinement loop of ``solve_system`` and ``solve/lanes.py::
    solve_system_lanes``.  The host values (denominators, residuals,
    counts) are arrays over the lanes; a mono system has one lane.  Where
    a lane system differs, as the JAX package's ``lanes.py`` differs from
    its ``refine.py``, the lane axis decides it below: the stall rule,
    converged lanes riding as zero systems, the Krylov method (PCG only),
    the starting guess (``x0_free`` None: zero), and the outputs (tuples
    over the lanes where mono has numbers)."""
    lanes = _lanes(system)
    storage_dtype = system.r0_b.dtype
    device = system.code.device

    if inner_dtype is None or inner_dtype == outer_dtype:
        r0 = system.initial_residual(
            torch.zeros_like(system.r0_b) if x0_free is None
            else x0_free.to(storage_dtype))
        with phase_timer(None, "solve/hierarchy_build"):
            M = make_precond(system.base() if lanes else system, precond,
                             precond_opts)
        with phase_timer(None, "solve/krylov"):
            res = _krylov(method, system, r0, system.b_norm, eps, maxiter,
                          M, refined=False, verbose=verbose,
                          history=history, _graph=graph)
        z = res.z if x0_free is None else x0_free + res.z
        return system.assemble_solution(z), res

    if storage_dtype != inner_dtype:
        system = system.astype(inner_dtype)
    with phase_timer(timings, "solve/hierarchy_build", device):
        M_lo = make_precond(system.base() if lanes else system, precond,
                            precond_opts)
    bn = system.b_norm.double().cpu().numpy().reshape(-1)
    denom = np.where(bn > 0, bn, 1.0)

    # fold the initial guess into the accumulator: one persistent f64
    # volume (the lanes start from zero)
    z_total = (torch.zeros(system.r0_b.shape, dtype=outer_dtype,
                           device=device) if x0_free is None
               else x0_free.to(outer_dtype))
    del x0_free
    total_iters = np.zeros(denom.shape, dtype=np.int64)
    rel = np.full(denom.shape, np.inf)
    prev_rel = np.full(denom.shape, np.inf)
    budget = int(maxiter)

    def out(a):
        """A host array as the outputs give it: a tuple over the lanes, a
        number for mono."""
        return tuple(a.tolist()) if lanes else a.item()

    stale = True  # does rel reflect the current z_total?
    for round_i in range(int(max_refine_rounds)):
        with phase_timer(timings, "solve/outer_residual", device):
            lo_first = round_i == 0
            if lo_first:
                r_hi, scale = _round0_estimate(system, z_total)
                rel = scale.cpu().numpy() / denom
                if (rel < 1e-3).any():  # too close to the f32 floor
                    lo_first = False
            if not lo_first:
                r_hi, scale = _outer_residual(system, z_total, outer_dtype)
                rel = scale.cpu().numpy() / denom
        stale = False
        if verbose >= 2 and lanes:
            line = ", ".join(f"{v:.3e}" for v in rel)
            print(f"  refine round (lanes): outer rel_res=[{line}]")
        elif verbose >= 2:
            print(f"  refine round: outer rel_res={rel[0]:.6e}")
        if history is not None:
            history.record_outer(round_i, out(rel))
        if bool((rel <= eps).all()):
            break
        # stagnation: the float32 inner solve can't improve further.  Mono:
        # the residual did not halve (a NaN residual does not stop it);
        # lanes: no unconverged lane halved its residual
        if (lockstep._lanes_stalled(rel, prev_rel, eps) if lanes else
                rel[0] >= prev_rel[0] * 0.5 and math.isfinite(prev_rel[0])):
            break
        if budget <= 0:
            break
        prev_rel = rel
        r_lo = _scale_inner_rhs(r_hi, scale, inner_dtype)
        if lanes:
            # converged lanes ride along as zero systems (alpha pins to 0);
            # the lanes drop each residual as soon as it is used, as their
            # memory model counts (lanes.py::LANE_FIELDS_OUTER)
            live = torch.from_numpy(~(rel <= eps)).to(device)
            r_lo = r_lo * _bcast(live.to(r_lo.dtype), r_lo)
            del r_hi
        # adaptive round tolerance from the worst lane: only the remaining
        # reduction (0.3 margin)
        worst = float(rel.max())
        need = float(eps / worst) * 0.3 if worst > 0 else inner_eps
        round_eps = min(max(inner_eps, need), 0.099)
        with phase_timer(timings, "solve/inner_round", device):
            if history is not None:
                history._base = int(total_iters.max())
            with phase_timer(None, "solve/krylov"):
                inner = _krylov(method, system, r_lo,
                                torch.ones(scale.shape, dtype=inner_dtype,
                                           device=device),
                                round_eps, min(budget, int(inner_round_cap)),
                                M_lo, refined=True, verbose=verbose,
                                history=history, _graph=graph)
            if lanes:
                del r_lo
            z_total = _accumulate(z_total, scale, inner.z)
            n_it = torch.as_tensor(inner.iterations).cpu().numpy()
            total_iters += n_it
            budget -= int(n_it.max())
        stale = True

    if stale:
        # only when the round cap ran out after an update: every break path
        # above measured the residual of the final z_total already
        r_hi, scale = _outer_residual(system, z_total, outer_dtype)
        rel = scale.cpu().numpy() / denom
        if history is not None:
            history.record_outer(-1, out(rel))
    x_full = system.astype(outer_dtype).assemble_solution(z_total)
    info = SolveResult(z=z_total, iterations=out(total_iters),
                       rel_res=out(rel), converged=out(rel <= eps))
    return x_full, info
