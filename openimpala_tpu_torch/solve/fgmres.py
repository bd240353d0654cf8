"""Restarted flexible GMRES (counterpart of ``openimpala_tpu/solve/
fgmres.py``; the reference's solver surface, Hypre ``StructFlexGMRES``,
``TortuosityHypre.cpp:664-692``).  On the eliminated SPD systems CG is the
better method; FGMRES serves ``solver_type = GMRES`` / ``FGMRES`` and
variable preconditioners (each restart cycle keeps the preconditioned
vectors Z, hence "flexible").

One loop: restart cycles advanced from the host, with the JAX package's
recurrences.  Modified Gram-Schmidt runs on the device; the small
Hessenberg column, the Givens rotations, the early exit on ``|g[j]| <=
eps_abs`` and the back-substitution run on the host in the working dtype
(numpy float32 or float64 scalars, the values the JAX loop carries on the
device).  That costs ONE host read per Arnoldi step (the step's column of
``j + 2`` values, whose last entry is the new basis vector's norm) and one
per cycle (the explicit end-of-cycle residual norm).  The JAX package's
fused ``lax.while_loop`` form exists for XLA and gives the same
iterations on finite inputs; it is not ported.

Memory: a cycle holds ``k + 1`` basis fields and ``k`` Z fields after ``k``
Arnoldi steps, allocated as the steps run.  ``_auto_restart`` caps the
depth m so that ``2m + 1`` fields fit beside what the solver holds: on a
CUDA device the memory ``torch.cuda.mem_get_info`` reports free (plus what
the caching allocator holds unused) less ``WORK_FIELDS`` fields of the
cycle's own work; on the CPU the JAX package's 6 GiB fallback, so that
both packages pick the same m there.

On X slabs (a system with a ``mesh``) every inner product of the
Gram-Schmidt loop and every norm is summed over the ranks in rank order
(``Mesh.allsum``), so every rank reads the same Hessenberg column and
takes the same exits, breaks and back-substitution; ``_auto_restart``
counts the rank's slab against its share of the card (the card's free
memory over the ranks on it, ``Mesh.ranks_on_device``) and takes the
smallest m over the ranks, since ranks that chose other depths would
wait on each other's sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.common import device_hbm_limit
from .cg import SolveResult, _dot, _mesh
from .preconditioners import IdentityPreconditioner

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}

# the basis budget where the device reports no memory (the CPU): the JAX
# package's constant, so both packages pick the same restart depth there
FALLBACK_BUDGET = 6 * 1024 ** 3
# fine-level fields a solve allocates beside its 2m + 1 basis fields: z and
# r of the running solve, the Arnoldi vector w and its Gram-Schmidt update,
# the preconditioner's temporaries and the end-of-cycle update.  With the
# default Galerkin cycle at 512^3 float32 the peak stood 3.25 fields above
# the solve's start and its basis (torch.cuda.max_memory_allocated on an
# H100, chip_smoke.py main[cli]); 8 leaves room for preconditioners with
# more temporaries (the smoothed-aggregation transfers)
WORK_FIELDS = 8
# share of the available memory the basis and the work fields may take
# (the caching allocator's rounding and fragmentation)
BUDGET_SHARE = 0.9


def _back_substitute(H, g, k: int, tiny):
    """y solving the upper-triangular ``H[:k, :k] y = g[:k]`` in H's dtype;
    a diagonal entry at or below ``tiny`` gets ``tiny`` added (the JAX
    package's guard)."""
    y = np.zeros(k, H.dtype)
    for i in range(k - 1, -1, -1):
        d = H[i, i]
        if not abs(d) > tiny:
            d = d + tiny
        acc = g[i]
        for c in range(i + 1, k):
            acc = acc - H[i, c] * y[c]
        y[i] = acc / d
    return y


def _arnoldi_cycle(system, precond, z, r, r0, eps_abs, restart: int,
                   beta=None):
    """One FGMRES(m) restart cycle: returns ``(z_new, r_new, ||r_new||,
    k)`` with the norm a host scalar of the working dtype and ``k`` the
    completed Arnoldi steps.

    The Arnoldi loop exits early once the rotated residual estimate
    ``|g[j]|`` drops to ``eps_abs``.  ``beta``: ``||r||`` as a host scalar
    where the caller has it (it is the last cycle's returned norm), else
    read here.  The residual returned is the explicit ``r0 - A z_new``,
    not the Arnoldi relation's: it seeds the next cycle and does not drift
    from the true residual."""
    ft = _NP_FLOAT[r.dtype]
    mesh = _mesh(system)
    m = int(restart)
    tiny = ft(1e-30)
    eps_abs = ft(eps_abs)
    if beta is None:
        beta = ft(float(torch.sqrt(_dot(r, r, mesh))))
    V = [r / float(beta if beta > 0 else ft(1.0))]
    Z = []
    H = np.zeros((m + 1, m), ft)
    cs = np.zeros(m, ft)
    sn = np.zeros(m, ft)
    g = np.zeros(m + 1, ft)
    g[0] = beta
    j = 0
    while j < m and (j == 0 or abs(g[j]) > eps_abs):
        zj = precond(V[j])
        w = system.apply(zj)
        col = []
        for i in range(j + 1):  # modified Gram-Schmidt, on the device
            hij = _dot(w, V[i], mesh)
            w = w - hij * V[i]
            col.append(hij)
        col.append(torch.sqrt(_dot(w, w, mesh)))
        hcol = np.zeros(m + 1, ft)
        hcol[:j + 2] = torch.stack(col).cpu().numpy()  # ONE read per step
        hj1 = hcol[j + 1]
        V.append(w / float(hj1 if hj1 > tiny else ft(1.0)))
        Z.append(zj)
        del w, col
        # the previous Givens rotations applied to the new column
        for i in range(j):
            t = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            b = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i], hcol[i + 1] = t, b
        # the new rotation annihilating hcol[j + 1]
        rho = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        rho_safe = rho if rho > tiny else ft(1.0)
        c, s = hcol[j] / rho_safe, hcol[j + 1] / rho_safe
        cs[j], sn[j] = c, s
        hcol[j], hcol[j + 1] = rho, ft(0.0)
        gj = g[j]
        g[j], g[j + 1] = c * gj, -s * gj
        H[:, j] = hcol
        j += 1
    k = j
    del V
    y = _back_substitute(H, g, k, tiny)
    z_new = torch.add(z, Z[0], alpha=float(y[0]))
    for i in range(1, k):
        z_new.add_(Z[i], alpha=float(y[i]))
    del Z
    r_new = r0 - system.apply(z_new)
    rnorm = ft(float(torch.sqrt(_dot(r_new, r_new, mesh))))
    return z_new, r_new, rnorm, k


def _fgmres_host_loop(system, r0, denom, eps, maxiter: int, precond,
                      restart: int, stall_break: bool = True,
                      verbose: int = 0, history=None):
    """Restart cycles advanced from the host, convergence checked there.
    ``iterations`` counts completed Arnoldi steps (a cycle may exit before
    m), so the budget is true operator applications, not cycles."""
    ft = _NP_FLOAT[r0.dtype]
    eps_v, denom_v = float(eps), float(denom)
    eps_abs = ft(eps_v * denom_v)
    z = torch.zeros_like(r0)
    r = r0
    it = 0
    stall = 0
    steps = []
    rnorm = ft(float(torch.sqrt(_dot(r, r, _mesh(system)))))
    rel = float(rnorm) / denom_v
    while rel > eps_v and it < maxiter:
        z, r, rnorm, k = _arnoldi_cycle(system, precond, z, r, r0, eps_abs,
                                        restart, beta=rnorm)
        it += int(k)
        steps.append(int(k))
        rel_new = float(rnorm) / denom_v
        if verbose >= 2:
            print(f"    fgmres it={it:5d}  rel_res={rel_new:.6e}")
        if history is not None:
            history.record_inner(it, rel_new)  # one point per restart cycle
        if math.isnan(rel_new):  # breakdown
            rel = rel_new
            break
        # plateau at the dtype's noise floor: two consecutive cycles
        # without progress end the solve, where an iterative-refinement
        # outer loop re-scales the residual and continues (``stall_break``);
        # an unrefined solve keeps its whole budget
        stall = stall + 1 if rel_new > rel * 0.999 else 0
        rel = rel_new
        if stall_break and stall >= 2:
            break
    return SolveResult(z=z, iterations=it, rel_res=rel,
                       converged=rel <= eps_v, restart=int(restart),
                       cycle_steps=tuple(steps))


def _device_hbm_budget(field_bytes: float, device, sharers: int = 1) -> float:
    """Bytes the Krylov basis may take on ``device``: on CUDA,
    ``BUDGET_SHARE`` of the free memory (``torch.cuda.mem_get_info``, plus
    what the caching allocator holds unused) over the ``sharers``
    processes that solve on the card, less ``WORK_FIELDS`` fields;
    ``FALLBACK_BUDGET`` where the device reports no memory (the CPU, as
    the JAX package's per-device constant)."""
    dev = torch.device(device)
    if device_hbm_limit(dev) <= 0:
        return FALLBACK_BUDGET
    free = torch.cuda.mem_get_info(dev)[0]
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return BUDGET_SHARE * free / sharers - WORK_FIELDS * field_bytes


def _auto_restart(r0, restart: int, mesh=None) -> int:
    """Cap the Krylov depth so that the 2m + 1 basis fields fit in the
    budget (``_device_hbm_budget``); at least 4.  Under a ``mesh`` ``r0``
    is the rank's slab, the budget its share of the card, and m the
    smallest over the ranks."""
    field_bytes = r0.numel() * r0.element_size()
    sharers = 1 if mesh is None else mesh.ranks_on_device()
    budget = _device_hbm_budget(field_bytes, r0.device, sharers)
    m = max(4, min(int(restart), int((budget / max(field_bytes, 1) - 1)
                                     // 2)))
    if mesh is not None:
        m = int(mesh.allmin(torch.tensor(m, device=mesh.device)))
    return m


def fgmres(system, r0, denom, eps, maxiter: int, precond=None,
           restart: int = 20, stall_break: bool = True, verbose: int = 0,
           history=None) -> SolveResult:
    """Solve ``A z = r0`` (free set, z0 = 0) with restarted flexible GMRES.

    ``stall_break``: arm the two-cycle plateau break (True only where an
    iterative-refinement outer loop exists to re-scale and continue).
    ``history``: opt-in ResidualHistory, one inner point per restart cycle.
    The result carries the restart depth it ran with (``restart``) and the
    Arnoldi steps of each cycle (``cycle_steps``)."""
    if precond is None:
        precond = IdentityPreconditioner()
    mesh = _mesh(system)
    denom = torch.as_tensor(denom, dtype=r0.dtype).to(r0.device)
    denom = torch.where(denom > 0, denom, torch.sqrt(_dot(r0, r0, mesh)))
    denom = torch.where(denom > 0, denom, 1.0)
    restart = _auto_restart(r0, restart, mesh)
    return _fgmres_host_loop(system, r0, denom, eps, int(maxiter), precond,
                             restart, stall_break=stall_break,
                             verbose=verbose, history=history)
