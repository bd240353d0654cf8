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
    iterations: object  # 0-d int32 tensor (cg) or int (refinement)
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


def _dot(a, b, mesh=None):
    """<a, b>; under a ``mesh``, summed over the ranks' slabs."""
    d = torch.sum(a * b)
    return d if mesh is None else mesh.allsum(d)


def _mesh(system):
    return getattr(system, "mesh", None)


def _cg_step(system, precond, state, denom, eps):
    """One guarded top-form PCG iteration (preconditioner applied at the
    start of the body, ``beta`` from the previous <r, y>), written into the
    state tensors in place.  Past convergence or breakdown, alpha pins to 0
    and z, r are fixed points; only the iteration counter is gated."""
    z, r, p, rz_prev, it, rel, done = state
    mesh = _mesh(system)
    y = precond(r)
    rz = _dot(r, y, mesh)
    # first iteration: rz_prev = 0 sentinel -> beta = 0, p = y
    beta = torch.where((rz_prev > 0) & ~done,
                       rz / torch.where(rz_prev > 0, rz_prev, 1.0), 0.0)
    torch.add(y, beta * p, out=p)
    ap, pap = system.apply_with_dot(p)
    ok = (pap > 0) & ~done
    alpha = torch.where(ok, rz / torch.where(pap > 0, pap, 1.0), 0.0)
    torch.add(z, alpha * p, out=z)
    torch.sub(r, alpha * ap, out=r)
    rel2 = torch.sqrt(_dot(r, r, mesh)) / denom
    done2 = done | (rel2 <= eps) | (pap <= 0)
    rz_prev.copy_(rz)
    it.copy_(torch.where(done, it, it + 1))
    rel.copy_(torch.where(done, rel, rel2))
    done.copy_(done2)


def _probe(it, rel, done):
    """The packed (it, done, rel) probe the host reads after each
    iteration (the arguments in the state's order)."""
    return (torch.stack([it.to(torch.float64), done.to(torch.float64),
                         rel.to(torch.float64)]),)


def _cg_loop(system, r0, denom, eps, maxiter: int, precond,
             verbose: int = 0, history=None, _graph=None):
    """PCG (see _cg_step) stopped at the first iteration whose probe shows
    it done, or at ``maxiter`` (the JAX package's ``_cg_loop``, ``it <
    maxiter``); on the CPU, on slabs and in the eager twin it executes
    exactly the iterations it counts.  On CUDA the iterations replay a
    CUDA graph (``utils/graphs.py::iterate``: at most ``IN_FLIGHT``
    done-gated ones past the count): ``_graph`` a ``ChunkGraph`` serves
    several calls (the refinement rounds of one solve), None makes one for
    this call."""
    dtype = r0.dtype
    dev = r0.device
    denom = torch.as_tensor(denom, dtype=dtype).to(dev)
    mesh = _mesh(system)
    rel0 = torch.sqrt(_dot(r0, r0, mesh)) / denom
    done0 = rel0 <= eps
    state = (torch.zeros_like(r0), r0.clone(), torch.zeros_like(r0),
             torch.zeros((), dtype=dtype, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev), rel0, done0)

    def stop(values):
        it_v, done_v, rel_v = values
        if verbose >= 2:
            print(f"    cg it={int(it_v):5d}  rel_res={rel_v:.6e}")
        if history is not None:
            history.record_inner(it_v, rel_v)
        return done_v > 0

    with graphs.solve_graph(dev, _graph, mesh) as holder:
        if holder:
            # eps enters as a tensor of the state's dtype: the value a
            # Python float takes in the comparison, and no frozen constant
            holder.load(("cg", id(system), id(precond)),
                        lambda *a: _cg_step(system, precond, a[:7], a[7],
                                            a[8]),
                        lambda *a: _probe(*a[4:7]),
                        state, (denom, torch.full((), eps, dtype=dtype,
                                                  device=dev)))
        if not bool(done0):  # r0 already meets eps: no iteration
            graphs.iterate(
                holder, lambda: _cg_step(system, precond, state, denom, eps),
                lambda: _probe(*state[4:])[0], maxiter, stop)
        z, r, p, rz, it, rel, done = holder.state if holder else state
        if holder and holder is _graph:
            # a shared holder's buffers: the next call overwrites them
            z, it, rel = z.clone(), it.clone(), rel.clone()
    return SolveResult(z=z, iterations=it, rel_res=rel, converged=rel <= eps)


def cg(system, r0, denom, eps, maxiter: int, precond=None, verbose: int = 0,
       history: ResidualHistory | None = None, _graph=None) -> SolveResult:
    """Solve ``A z = r0`` on the free set with z0 = 0.

    ``denom`` is the relative-residual denominator (pass ``system.b_norm``
    for Hypre's ``||r||/||b|| <= eps``); a zero denominator falls back to
    ``||r0||``, and to 1 when r0 is zero too.
    """
    if precond is None:
        precond = _IDENTITY  # one object: a shared graph's key holds it
    denom = torch.as_tensor(denom, dtype=r0.dtype).to(r0.device)
    denom = torch.where(denom > 0, denom,
                        torch.sqrt(_dot(r0, r0, _mesh(system))))
    denom = torch.where(denom > 0, denom, 1.0)
    return _cg_loop(system, r0, denom, eps, int(maxiter), precond,
                    verbose=verbose, history=history, _graph=_graph)
