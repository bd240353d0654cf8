"""Preconditioned conjugate gradients on the free-set stencil system
(counterpart of ``openimpala_tpu/solve/cg.py``).

One loop on every device: the top-form PCG recurrence with a done-gated
iteration counter, and a host read of the packed (iterations, done, rel)
probe after every iteration, so the loop stops at the iteration that
converges, as the JAX package's ``_cg_loop`` does.  On CUDA an iteration
is a CUDA graph (``utils/graphs.py``, the counterpart of the JAX
package's jitted ``_cg_chunk``): a solve's first iteration runs eagerly,
every later one is a replay of its capture, and the reads are pipelined:
the host keeps ``graphs.IN_FLIGHT`` iterations enqueued behind the one
whose probe it reads, so the card does not wait for the read, and a solve
executes at most that many done-gated iterations past its count.  The JAX
package's chunks of 16 exist for its TPU runtime only and are not kept.

The step and the loop serve the mono solve (a ``StencilSystem``) and the
lockstep lanes (``solve/lanes.py::LaneSystem``, whose state is (L, X, Y,
Z)) alike.  The system's lane axis decides the three places where they
differ: a dot product is one full sum or one sum per lane, a per-lane
scalar is shaped to broadcast over the lanes, and the preconditioner is
applied whole or lane by lane.

On X slabs (a system with a ``mesh``) every dot product and norm is summed
over the ranks, so every rank takes the same branch from the same
scalars; the step is not captured (a collective of the gloo backend
cannot be), so a slab solve runs its iterations eagerly, and reads its
probe after every iteration.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import graphs
from .preconditioners import IdentityPreconditioner


@dataclasses.dataclass
class SolveResult:
    z: torch.Tensor  # correction on the free set (add to x_forced + x0)
    # 0-d int32 tensor (cg), int (refinement); per lane: an (L,) tensor,
    # a tuple
    iterations: object
    rel_res: object  # final ||r|| / denom
    converged: object
    # FGMRES only: the restart depth m it ran with and the Arnoldi steps
    # of each restart cycle
    restart: int | None = None
    cycle_steps: tuple = ()


@dataclasses.dataclass
class ResidualHistory:
    """Opt-in convergence trace: ``inner`` holds ``(cumulative_krylov_
    iteration, rel_res)`` per iteration (per restart cycle for FGMRES),
    ``outer`` holds ``(refine_round, rel_res)`` per refinement round
    (round -1: the final re-measure)."""

    inner: list = dataclasses.field(default_factory=list)
    outer: list = dataclasses.field(default_factory=list)
    # running Krylov-iteration offset: solve/refine.py sets it before each
    # refinement round so ``inner`` stays cumulative across rounds
    _base: int = 0

    @staticmethod
    def _val(rel):
        """A float, or a tuple of floats where a lockstep solve
        (``solve/lanes.py``) observes one residual per lane."""
        if hasattr(rel, "tolist"):  # a tensor or numpy value
            rel = rel.tolist()
        if isinstance(rel, (list, tuple)):
            return tuple(float(v) for v in rel)
        return float(rel)

    def record_inner(self, it: int, rel):
        self.inner.append((self._base + int(it), self._val(rel)))

    def record_outer(self, round_i: int, rel):
        self.outer.append((int(round_i), self._val(rel)))


def jacobi_preconditioner(system):
    """Diagonal scaling of ``system`` (``preconditioners.
    JacobiPreconditioner``)."""
    from .preconditioners import JacobiPreconditioner

    return JacobiPreconditioner.from_system(system)


_IDENTITY = IdentityPreconditioner()
_VOL = (1, 2, 3)  # the volume axes of a lane system's (L, X, Y, Z) state


def _mesh(system):
    return getattr(system, "mesh", None)


def _lanes(system) -> bool:
    """Whether ``system`` has a lane axis (``solve/lanes.py::LaneSystem``;
    a ``StencilSystem`` has none)."""
    return hasattr(system, "lanes")


def _dot(a, b, mesh=None, dim=None):
    """<a, b>, over the axes ``dim`` (None: all of them); under a
    ``mesh``, summed over the ranks' slabs."""
    d = torch.sum(a * b) if dim is None else torch.sum(a * b, dim=dim)
    return d if mesh is None else mesh.allsum(d)


def _vdot(system, a, b):
    """<a, b> of two of ``system``'s vectors: a 0-d sum, or an (L,) one
    per lane where ``system`` has a lane axis."""
    return _dot(a, b, _mesh(system), _VOL if _lanes(system) else None)


def _bcast(v, x):
    """The scalar ``v`` shaped to broadcast over ``x``: a 0-d one as it
    is, an (L,) one over the lanes of an (L, X, Y, Z) stack."""
    return v.reshape(v.shape + (1,) * (x.dim() - 1)) if v.dim() else v


def _precondition(system, precond, r):
    """``precond`` applied to ``r``: whole, or lane by lane where
    ``system`` has a lane axis (a lane system's preconditioner is built
    for one lane, ``LaneSystem.base()``)."""
    if precond is _IDENTITY or not _lanes(system):
        return precond(r)
    return torch.stack([precond(r[i]) for i in range(r.shape[0])])


def _cg_step(system, precond, state, denom, eps):
    """One guarded top-form PCG iteration (preconditioner applied at the
    start of the body, ``beta`` from the previous <r, y>), written into the
    state tensors in place.  Past convergence or breakdown, alpha pins to 0
    and z, r are fixed points; only the iteration counter is gated.  The
    scalars are 0-d, or (L,) on a lane system, where each lane runs this
    recurrence on its own and is gated on its own."""
    z, r, p, rz_prev, it, rel, done = state
    y = _precondition(system, precond, r)
    rz = _vdot(system, r, y)
    # first iteration: rz_prev = 0 sentinel -> beta = 0, p = y
    beta = torch.where((rz_prev > 0) & ~done,
                       rz / torch.where(rz_prev > 0, rz_prev, 1.0), 0.0)
    torch.add(y, _bcast(beta, p) * p, out=p)
    ap, pap = system.apply_with_dot(p)
    ok = (pap > 0) & ~done
    alpha = torch.where(ok, rz / torch.where(pap > 0, pap, 1.0), 0.0)
    torch.add(z, _bcast(alpha, p) * p, out=z)
    torch.sub(r, _bcast(alpha, ap) * ap, out=r)
    rel2 = torch.sqrt(_vdot(system, r, r)) / denom
    done2 = done | (rel2 <= eps) | (pap <= 0)
    rz_prev.copy_(rz)
    it.copy_(torch.where(done, it, it + 1))
    rel.copy_(torch.where(done, rel, rel2))
    done.copy_(done2)


def _probe(state):
    """The packed (it, done, rel) probe the host reads after each
    iteration: (3,), or (3, L) on a lane system."""
    _, _, _, _, it, rel, done = state
    return torch.stack([it.to(torch.float64), done.to(torch.float64),
                        rel.to(torch.float64)])


def _cg_loop(system, r0, denom, eps, maxiter: int, precond,
             verbose: int = 0, history=None, _graph=None):
    """PCG (see _cg_step) from z0 = 0, stopped at the first iteration
    whose probe shows it done, or at ``maxiter`` (the JAX package's
    ``_cg_loop``, ``it < maxiter``); a lane system stops when every lane
    is done or its largest count reaches ``maxiter``.  A zero ``denom``
    falls back to ``||r0||``, and to 1 when r0 is zero too; ``precond``
    None is the identity.  On the CPU, on slabs and in the eager twin it
    executes exactly the iterations it counts.  On CUDA the iterations
    replay a CUDA graph (``utils/graphs.py::pcg``: at most ``IN_FLIGHT``
    done-gated ones past the count): ``_graph`` a ``ChunkGraph`` serves
    several calls (the refinement rounds of one solve), None makes one for
    this call."""
    if precond is None:
        precond = _IDENTITY  # one object: a shared graph's key holds it
    dtype = r0.dtype
    dev = r0.device
    lanes = _lanes(system)
    norm0 = torch.sqrt(_vdot(system, r0, r0))
    denom = torch.as_tensor(denom, dtype=dtype).to(dev)
    denom = torch.where(denom > 0, denom, norm0)
    denom = torch.where(denom > 0, denom, 1.0)
    rel0 = norm0 / denom
    del norm0  # held through the loop it would add a block to the peak
    state = (torch.zeros_like(r0), r0.clone(), torch.zeros_like(r0),
             torch.zeros(rel0.shape, dtype=dtype, device=dev),
             torch.zeros(rel0.shape, dtype=torch.int32, device=dev), rel0,
             rel0 <= eps)

    def stop(values):
        its, dones, rels = values  # numbers, or lists over the lanes
        it = int(max(its)) if lanes else int(its)  # the largest lane count
        if verbose >= 2 and lanes:
            line = ", ".join(f"{v:.3e}" for v in rels)
            print(f"    cg-lanes it={it:5d}  rel_res=[{line}]")
        elif verbose >= 2:
            print(f"    cg it={it:5d}  rel_res={rels:.6e}")
        if history is not None:
            history.record_inner(it, rels)
        return all(d > 0 for d in dones) if lanes else dones > 0

    z, it, rel = graphs.pcg(
        ("cg", id(system), id(precond)),
        lambda s, d, e: _cg_step(system, precond, s, d, e), _probe, state,
        denom, eps, maxiter, stop, _graph, _mesh(system))
    return SolveResult(z=z, iterations=it, rel_res=rel, converged=rel <= eps)


def cg(system, r0, denom, eps, maxiter: int, precond=None, verbose: int = 0,
       history: ResidualHistory | None = None, _graph=None) -> SolveResult:
    """Solve ``A z = r0`` on the free set with z0 = 0.

    ``denom`` is the relative-residual denominator (pass ``system.b_norm``
    for Hypre's ``||r||/||b|| <= eps``); a zero denominator falls back to
    ``||r0||``, and to 1 when r0 is zero too.
    """
    return _cg_loop(system, r0, denom, eps, int(maxiter), precond,
                    verbose=verbose, history=history, _graph=_graph)
