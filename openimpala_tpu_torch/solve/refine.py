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
"""

from __future__ import annotations

import math

import torch

from ..utils import graphs
from ..utils.profiling import phase_timer
from .cg import SolveResult, _mesh, cg
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


def _norm(r, mesh):
    """||r||_2; under a ``mesh``, over every rank's slab."""
    s = torch.sum(r * r)
    return torch.sqrt(s if mesh is None else mesh.allsum(s))


def _krylov(method: str, system, r0, denom, eps, maxiter, precond,
            refined: bool = True, verbose: int = 0, history=None,
            _graph=None):
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
    norm."""
    r = system.astype(outer_dtype).initial_residual(x_outer)
    return r, _norm(r, _mesh(system))


def _round0_estimate(system, z_total):
    """Round-0 residual in the Krylov (storage) dtype and its float64 norm:
    the first residual is far above the float32 noise floor."""
    r_hi = system.initial_residual(z_total.to(system.r0_b.dtype))
    s = torch.sum(r_hi.to(torch.float32) ** 2)
    if _mesh(system) is not None:
        s = _mesh(system).allsum(s)
    scale = torch.sqrt(s.to(torch.float64))
    return r_hi, scale


def _scale_inner_rhs(r_hi, scale, inner_dtype):
    """Normalised inner-round RHS (r / ||r||) in the Krylov dtype."""
    return (r_hi / torch.where(scale > 0, scale, 1.0).to(r_hi.dtype)
            ).to(inner_dtype)


def _accumulate(z_total, scale, z):
    """High-precision accumulation z_total + scale * z."""
    return z_total + scale * z.to(z_total.dtype)


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
    """Solve the StencilSystem to ``||b - A x|| / ||b_full|| <= eps``.

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
    storage_dtype = system.r0_b.dtype
    device = system.code.device

    if inner_dtype is None or inner_dtype == outer_dtype:
        r0 = system.initial_residual(x0_free.to(storage_dtype))
        with phase_timer(None, "solve/hierarchy_build"):
            M = make_precond(system, precond, precond_opts)
        with phase_timer(None, "solve/krylov"):
            res = _krylov(method, system, r0, system.b_norm, eps, maxiter,
                          M, refined=False, verbose=verbose,
                          history=history, _graph=graph)
        x_full = system.assemble_solution(x0_free + res.z)
        return x_full, res

    if storage_dtype != inner_dtype:
        system = system.astype(inner_dtype)
    with phase_timer(timings, "solve/hierarchy_build", device):
        M_lo = make_precond(system, precond, precond_opts)
    bn = float(system.b_norm)
    denom = bn if bn > 0 else 1.0

    # fold the initial guess into the accumulator: one persistent f64 volume
    z_total = x0_free.to(outer_dtype)
    del x0_free
    total_iters = 0
    rel = math.inf
    prev_rel = math.inf
    budget = int(maxiter)

    stale = True  # does rel reflect the current z_total?
    for round_i in range(int(max_refine_rounds)):
        with phase_timer(timings, "solve/outer_residual", device):
            lo_first = round_i == 0
            if lo_first:
                r_hi, scale = _round0_estimate(system, z_total)
                rel = float(scale) / denom
                if rel < 1e-3:  # too close to the f32 floor to trust
                    lo_first = False
            if not lo_first:
                r_hi, scale = _outer_residual(system, z_total, outer_dtype)
                rel = float(scale) / denom
        stale = False
        if verbose >= 2:
            print(f"  refine round: outer rel_res={rel:.6e}")
        if history is not None:
            history.record_outer(round_i, rel)
        if rel <= eps:
            break
        if rel >= prev_rel * 0.5 and math.isfinite(prev_rel):
            break  # stagnation: the float32 inner solve can't improve further
        if budget <= 0:
            break
        prev_rel = rel
        r_lo = _scale_inner_rhs(r_hi, scale, inner_dtype)
        # adaptive round tolerance: only the remaining reduction (0.3 margin)
        need = float(eps / rel) * 0.3 if rel > 0 else inner_eps
        round_eps = min(max(inner_eps, need), 0.099)
        with phase_timer(timings, "solve/inner_round", device):
            if history is not None:
                history._base = total_iters
            with phase_timer(None, "solve/krylov"):
                inner = _krylov(method, system, r_lo,
                                torch.ones((), dtype=inner_dtype,
                                           device=device),
                                round_eps, min(budget, int(inner_round_cap)),
                                M_lo, refined=True, verbose=verbose,
                                history=history, _graph=graph)
            z_total = _accumulate(z_total, scale, inner.z)
            n_it = int(inner.iterations)
            total_iters += n_it
            budget -= n_it
        stale = True

    if stale:
        # only when the round cap ran out after an update: every break path
        # above measured the residual of the final z_total already
        r_hi, scale = _outer_residual(system, z_total, outer_dtype)
        rel = float(scale) / denom
        if history is not None:
            history.record_outer(-1, rel)
    x_full = system.astype(outer_dtype).assemble_solution(z_total)
    info = SolveResult(z=z_total, iterations=total_iters, rel_res=rel,
                       converged=rel <= eps)
    return x_full, info
