"""Batched solves for the REV study (counterpart of
``openimpala_tpu/solve/batched.py``).

The REV sweep solves many independent same-size periodic cell problems, so
a whole group runs as ONE batched program: the state carries a leading
batch dimension, the PCG advances every lane in lockstep with per-lane
alpha, beta and residual, and lanes that have converged keep their state.

* **Chebyshev preconditioning**: a fixed SPD polynomial in the
  Jacobi-scaled operator, stateless, so one object serves the whole batch.
* **The operator is batched in the kernel**: ``A p`` and ``<p, A p>`` of
  every lane come from one launch of kernel K4 on the explicit (diag, free)
  arrays the preconditioner holds (``ops/stencil.py::apply_restricted``),
  each lane wrapping on its own.
* **One read per iteration**: after every iteration one host read of
  (the largest lane count, all done) says whether every lane is done, and
  the loop stops there.  On CUDA an iteration is a CUDA graph
  (``utils/graphs.py``), captured once per direction and replayed in every
  refinement round, and the reads are pipelined (``graphs.pcg``: at
  most ``IN_FLIGHT`` done-gated iterations past the count).  The JAX
  package's chunks of 25 exist for its TPU runtime only.
* **Memory-sized groups**: ``batched_deff`` splits the crop stack into
  groups sized from the refinement state's bytes per crop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.flux import deff_integrand_sum
from ..ops.stencil import (
    apply_restricted,
    apply_restricted_with_dot,
    decode_code,
    make_cell_problem_system,
)
from ..utils import graphs
from ..utils.common import resolve_device
from ..utils.profiling import phase_timer
from .preconditioners import ChebyshevPreconditioner, JacobiPreconditioner

_VOL = (1, 2, 3)  # the volume axes of a (B, X, Y, Z) stack


def _lanes(v):
    """A (B,) tensor shaped to broadcast over (B, X, Y, Z)."""
    return v[:, None, None, None]


def _make_precond(systems, r0, precond: str, degree: int):
    """The batch's preconditioner on the explicit (diag, free) arrays of
    ``systems`` in ``r0``'s dtype; the PCG applies the operator from the
    same two arrays."""
    diag = systems.diag.expand(r0.shape).to(r0.dtype).contiguous()
    if precond == "cheby":
        return ChebyshevPreconditioner(
            diag=diag, free=systems.free, w=systems.w,
            periodic=systems.periodic, degree=degree)
    return JacobiPreconditioner(diag=diag, free=systems.free)


def _batched_step(systems, precond, state, denom, eps):
    """One lockstep PCG iteration over the batch, written into the state
    tensors in place.  Every lane is computed; a lane that is done keeps
    its old state."""
    M = precond
    z, r, p, rz, it, rel, done = state
    ap, pap = apply_restricted_with_dot(p, M.diag, M.free, systems.w,
                                        systems.periodic)
    ok = pap > 0
    alpha = torch.where(ok, rz / torch.where(ok, pap, 1.0), 0.0)
    z2 = z + _lanes(alpha) * p
    r2 = r - _lanes(alpha) * ap
    rel2 = torch.sqrt(torch.sum(r2 * r2, dim=_VOL)) / denom
    y = M(r2)
    rz2 = torch.sum(r2 * y, dim=_VOL)
    beta = torch.where(rz > 0, rz2 / torch.where(rz > 0, rz, 1.0), 0.0)
    p2 = y + _lanes(beta) * p
    done2 = done | (rel2 <= eps) | ~ok
    keep = _lanes(done)
    torch.where(keep, z, z2, out=z)
    torch.where(keep, r, r2, out=r)
    torch.where(keep, p, p2, out=p)
    rz.copy_(torch.where(done, rz, rz2))
    it.copy_(torch.where(done, it, it + 1))
    rel.copy_(torch.where(done, rel, rel2))
    done.copy_(done2)


def _batched_probe(state):
    """The packed (max iterations, all done) probe."""
    it, done = state[4], state[6]
    return torch.stack([it.max().to(torch.float64),
                        done.all().to(torch.float64)])


def _batched_cg(systems, r0, denom, eps, maxiter: int, precond,
                _graph=None):
    """Batched PCG, one host read per iteration (``graphs.pcg``):
    z with z0 = 0 per lane, stopped when every lane is done or the largest
    lane count reaches ``maxiter``.  Returns ``(z, iterations (B,),
    rel_res (B,))``.  ``_graph``: as in ``solve/cg.py::_cg_loop``."""
    B = r0.shape[0]
    y = precond(r0)
    rz = torch.sum(r0 * y, dim=_VOL)
    rel0 = torch.sqrt(torch.sum(r0 * r0, dim=_VOL)) / denom
    state = (torch.zeros_like(r0), r0.clone(), y, rz,
             torch.zeros((B,), dtype=torch.int32, device=r0.device),
             rel0, rel0 <= eps)
    return graphs.pcg(
        ("batched", id(systems), id(precond)),
        lambda s, d, e: _batched_step(systems, precond, s, d, e),
        _batched_probe, state, denom, float(eps), maxiter,
        lambda values: values[1] > 0, _graph)


def batched_cell_problems(masks, direction_k: int, eps: float, maxiter: int,
                          dx=(1.0, 1.0, 1.0), inner_dtype=torch.float32,
                          outer_dtype=torch.float64,
                          max_refine_rounds: int = 6,
                          inner_round_cap: int = 5000, precond: str = "cheby",
                          cheby_degree: int = 12):
    """Solve chi_k for a (B, X, Y, Z) stack of active masks (a bool tensor;
    the solve runs on its device).

    Returns ``(chi (B,X,Y,Z) outer_dtype, rel_res (B,), converged (B,))``.
    On CUDA every refinement round's PCG replays one CUDA graph, released
    when the call returns.
    """
    with graphs.solve_graph(masks.device) as graph:
        return _cell_problems(masks, direction_k, eps, maxiter, dx,
                              inner_dtype, outer_dtype, max_refine_rounds,
                              inner_round_cap, precond, cheby_degree, graph)


def _cell_problems(masks, direction_k, eps, maxiter, dx, inner_dtype,
                   outer_dtype, max_refine_rounds, inner_round_cap, precond,
                   cheby_degree, graph):
    masks = masks.to(torch.bool)
    dev = masks.device
    systems = make_cell_problem_system(masks, direction_k, dx,
                                       dtype=inner_dtype)
    w, periodic, free = systems.w, systems.periodic, systems.free

    denom_lo = torch.where(systems.b_norm > 0, systems.b_norm, 1.0)
    denom_hi = denom_lo.to(outer_dtype)

    B = masks.shape[0]
    z_total = torch.zeros(masks.shape, dtype=outer_dtype, device=dev)
    # the outer residual's operator: (diag, free) in outer_dtype (x_forced
    # is zero for the cell problem, so the iterate is z itself)
    diag_hi = decode_code(systems.code, w, outer_dtype)[0]
    r0_hi = systems.r0_b.to(outer_dtype)

    def outer_residual(z):
        r = torch.where(
            free, r0_hi - apply_restricted(z, diag_hi, free, w, periodic),
            torch.zeros((), dtype=outer_dtype, device=dev))
        return r, torch.sqrt(torch.sum(r * r, dim=_VOL))

    ones = torch.ones((B,), dtype=inner_dtype, device=dev)
    budget = int(maxiter)
    M = None
    for _ in range(int(max_refine_rounds)):
        r_hi, scale = outer_residual(z_total)
        rel = scale / denom_hi
        worst = float(rel.max())  # the round's one host read
        if worst <= eps or budget <= 0:
            break
        safe = torch.where(scale > 0, scale, 1.0)
        r_lo = (r_hi / _lanes(safe)).to(inner_dtype)
        del r_hi
        if M is None:
            # depends on the systems and on r_lo's shape and dtype only:
            # built once, the same object every round
            M = _make_precond(systems, r_lo, precond, cheby_degree)
        # adaptive round tolerance (see solve/refine.py): only the remaining
        # reduction factor is requested, with a 0.3 safety margin
        need = float(eps / worst) * 0.3 if worst > 0 else 1e-5
        round_eps = min(max(1e-5, need), 0.099)
        with phase_timer(None, "solve/krylov"):
            z, iters, _ = _batched_cg(systems, r_lo, ones, round_eps,
                                      min(budget, int(inner_round_cap)), M,
                                      _graph=graph)
        z_total = z_total + _lanes(safe) * z.to(outer_dtype)
        budget -= int(iters.max())
        del z, r_lo

    r_hi, scale = outer_residual(z_total)
    rel = scale / denom_hi
    # assemble_solution: x_forced (zero) + the free-masked iterate
    chi = torch.where(free, z_total,
                      torch.zeros((), dtype=outer_dtype, device=dev))
    return chi, rel, rel <= eps


# Peak float32-field equivalents alive per crop through one refinement
# round, the model behind the group size: the system (bf16 code, float32
# rhs), the float64 accumulator, diagonal, rhs and outer residual with its
# transients, the float32 Chebyshev diagonal, the CG state (z, r, p), the
# matvec and preconditioner temporaries and the frozen-lane selects.
# Measured: 33,030,368 bytes per crop at the peak of a 64 x 64^3 group,
# 31.5 fields (NVIDIA H100 80GB HBM3, chip_smoke.py main[rev]; PERF.md).
FIELDS_PER_CROP = 32

# share of the card's free memory a group may take, and the budget where
# there is no card to ask (a CPU run)
BUDGET_SHARE = 0.5
CPU_BUDGET_BYTES = 4 * 1024 ** 3


def _auto_group_size(crop_shape, requested=None, budget_bytes=None,
                     device=None):
    """Crops per device group: the budget over FIELDS_PER_CROP float32-field
    equivalents per crop.  The budget is ``budget_bytes`` if given, else
    BUDGET_SHARE of the memory free on the CUDA ``device`` right now
    (``torch.cuda.mem_get_info``), else CPU_BUDGET_BYTES."""
    if requested is not None:
        return max(1, int(requested))
    crop_bytes = int(np.prod(crop_shape)) * 4
    if budget_bytes is not None:
        budget = int(budget_bytes)
    elif device is not None and torch.device(device).type == "cuda":
        budget = int(BUDGET_SHARE * torch.cuda.mem_get_info(device)[0])
    else:
        budget = CPU_BUDGET_BYTES
    return max(1, budget // (FIELDS_PER_CROP * crop_bytes))


def batched_deff(crops, phase_id: int, eps: float = 1e-9,
                 maxiter: int = 20000, dx=(1.0, 1.0, 1.0), group_size=None,
                 verbose: int = 0, budget_bytes=None, device=None, **kw):
    """D_eff tensors for a (B, n, n, n) stack of phase crops, streamed in
    memory-sized groups.  ``device``: None means CUDA; pass ``"cpu"`` for
    the CPU.

    Returns ``(deff (B, 3, 3) float64 ndarray, converged (B,) bool)``.
    """
    dev = resolve_device(device)
    crops = np.asarray(crops)
    B = crops.shape[0]
    with phase_timer(None, "solve/group_size"):
        G = _auto_group_size(crops.shape[1:], group_size, budget_bytes, dev)
    deffs = np.zeros((B, 3, 3))
    convs = np.zeros((B,), bool)
    n_total = int(np.prod(crops.shape[1:]))
    for g0 in range(0, B, G):
        g1 = min(B, g0 + G)
        with phase_timer(None, "solve/upload"):
            masks = torch.from_numpy(crops[g0:g1] == phase_id).to(dev)
            conv = torch.ones((g1 - g0,), dtype=torch.bool, device=dev)
        chis = []
        for k in range(3):
            with phase_timer(None, "solve/cell_problem"):
                chi_k, rel, ck = batched_cell_problems(masks, k, eps,
                                                       maxiter, dx, **kw)
            chis.append(chi_k)
            conv = conv & ck
        with phase_timer(None, "solve/readback"):
            sums = deff_integrand_sum(chis[0], chis[1], chis[2], masks, dx)
            deffs[g0:g1] = sums.cpu().numpy() / n_total
            convs[g0:g1] = conv.cpu().numpy()
        del chis, sums, masks
        if verbose:
            print(f"  REV batch group {g0}-{g1 - 1}: "
                  f"converged={int(convs[g0:g1].sum())}/{g1 - g0}")
    return deffs, convs
