"""Preconditioned conjugate gradients on the free-set stencil system
(counterpart of ``openimpala_tpu/solve/cg.py``).

One loop on every device: the top-form PCG recurrence advanced ``chunk``
iterations at a time with a done-gated iteration counter, and ONE host read
per chunk (a packed (iterations, done, rel) probe).  Inside a chunk no
device value is read back, so the card runs the chunk's kernels back to
back.
"""

from __future__ import annotations

import dataclasses

import torch

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
    iteration, rel_res)`` per chunk, ``outer`` holds ``(refine_round,
    rel_res)`` per refinement round (round -1: the final re-measure)."""

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


def _dot(a, b):
    return torch.sum(a * b)


def _cg_chunk(system, precond, state, denom, eps, chunk: int):
    """``chunk`` guarded top-form PCG iterations (preconditioner applied at
    the start of the body, ``beta`` from the previous <r, y>).  Past
    convergence or breakdown, alpha pins to 0 and z, r are fixed points;
    only the iteration counter is gated.  Returns the new state and the
    packed (it, done, rel) probe, still on the device."""
    M = precond
    for _ in range(chunk):
        z, r, p, rz_prev, it, rel, done = state
        y = M(r)
        rz = _dot(r, y)
        # first iteration: rz_prev = 0 sentinel -> beta = 0, p = y
        beta = torch.where((rz_prev > 0) & ~done,
                           rz / torch.where(rz_prev > 0, rz_prev, 1.0), 0.0)
        p = y + beta * p
        ap, pap = system.apply_with_dot(p)
        ok = (pap > 0) & ~done
        alpha = torch.where(ok, rz / torch.where(pap > 0, pap, 1.0), 0.0)
        z = z + alpha * p
        r = r - alpha * ap
        rel2 = torch.sqrt(_dot(r, r)) / denom
        done2 = done | (rel2 <= eps) | (pap <= 0)
        state = (z, r, p, rz, torch.where(done, it, it + 1),
                 torch.where(done, rel, rel2), done2)
    probe = torch.stack([state[4].to(torch.float64),
                         state[6].to(torch.float64),
                         state[5].to(torch.float64)])
    return state, probe


def _cg_chunked_loop(system, r0, denom, eps, maxiter: int, precond,
                     chunk: int = 16, verbose: int = 0, history=None):
    """PCG advancing ``chunk`` iterations per host check (see _cg_chunk);
    the iteration count may overshoot ``maxiter`` by less than a chunk."""
    dtype = r0.dtype
    denom = torch.as_tensor(denom, dtype=dtype).to(r0.device)
    rel0 = torch.sqrt(_dot(r0, r0)) / denom
    done0 = rel0 <= eps
    state = (torch.zeros_like(r0), r0, torch.zeros_like(r0),
             torch.zeros((), dtype=dtype, device=r0.device),
             torch.zeros((), dtype=torch.int32, device=r0.device), rel0, done0)
    while True:
        state, probe = _cg_chunk(system, precond, state, denom, eps, chunk)
        it_v, done_v, rel_v = probe.tolist()  # ONE read per chunk
        it = int(it_v)
        if verbose >= 2:
            print(f"    cg it={it:5d}  rel_res={rel_v:.6e}")
        if history is not None:
            history.record_inner(it, rel_v)
        if done_v > 0 or it >= maxiter:
            break
    z, r, p, rz, it, rel, done = state
    return SolveResult(z=z, iterations=it, rel_res=rel, converged=rel <= eps)


def cg(system, r0, denom, eps, maxiter: int, precond=None, verbose: int = 0,
       history: ResidualHistory | None = None) -> SolveResult:
    """Solve ``A z = r0`` on the free set with z0 = 0.

    ``denom`` is the relative-residual denominator (pass ``system.b_norm``
    for Hypre's ``||r||/||b|| <= eps``); a zero denominator falls back to
    ``||r0||``, and to 1 when r0 is zero too.
    """
    if precond is None:
        precond = IdentityPreconditioner()
    denom = torch.as_tensor(denom, dtype=r0.dtype).to(r0.device)
    denom = torch.where(denom > 0, denom, torch.sqrt(_dot(r0, r0)))
    denom = torch.where(denom > 0, denom, 1.0)
    return _cg_chunked_loop(system, r0, denom, eps, int(maxiter), precond,
                            verbose=verbose, history=history)
