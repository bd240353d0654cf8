"""Percolation, flow-through tortuosity, the periodic cell problems and
the D_eff tensor, on the upstream discretisation.

* Percolation: the cells of the phase joined by faces to both the inlet
  and the outlet plane (``TortuosityHypre.cpp:394-558``), by repeated
  dilation inside the phase.
* Flow-through system (``TortuosityHypreFill.F90:44-262``): an active cell
  with no active neighbour is decoupled; the active cells of the inlet
  and outlet planes hold ``vlo`` and ``vhi``; every other active cell
  balances ``w_f`` times the difference to each active neighbour.
  Converged when ``||b - A x|| <= eps * ||b_full||``, with ``b_full``
  holding ``vlo`` and ``vhi`` on the fixed cells (``:686-688``).
* Fluxes (``:1000-1134``): over the inlet and outlet planes, each active
  cell whose inward neighbour is active, ``-(phi_inner - phi_face) / dx``
  (mirrored at the outlet), times the face area element.  Conserved when
  the two magnitudes differ by at most 1e-6 of their mean (``:794``);
  ``tau = active_vf / D`` with ``D = (mean flux / area) / |grad|``.
* Cell problem for ``chi_k`` (``EffDiffFillMtx.F90:42-264``): every axis
  wraps; an active cell's diagonal sums all six faces, its neighbours
  couple where active, and its right-hand side is
  ``-(m+ - m-)/(2 dx) + (1 - m-)/dx - (1 - m+)/dx`` with ``m+-`` the
  phase of the neighbours along ``k``.  Converged when
  ``||b - A chi|| <= eps * ||b||``.
* Tensor (``Diffusion.cpp:60-167``): ``D_ab = (delta_ab n_active -
  sum_active (chi_b[i+e_a] - chi_b[i-e_a]) / (2 dx_a)) / n_total``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .laplace import Multigrid, Operator, conductances, pcg

TINY_FLUX = 1e-15
FLUX_TOL = 1e-6
# the reference converges far below the 1e-9 that a configuration asks of
# the measured program, so that its own error is no part of a gap
TOL = 1e-12


def _weights(dx):
    return tuple(1.0 / float(d) ** 2 for d in dx)


def _plane(x, axis, index):
    return x.select(axis, index)


def _dilate(cur, ok, out):
    """One round: ``out = ok & (cur | its six face neighbours)``."""
    out.copy_(cur)
    for a in range(3):
        n = cur.shape[a]
        if n > 1:
            out.narrow(a, 0, n - 1).logical_or_(cur.narrow(a, 1, n - 1))
            out.narrow(a, 1, n - 1).logical_or_(cur.narrow(a, 0, n - 1))
    out.logical_and_(ok)
    return out


def _fill(ok, seed, check_every=16):
    cur, nxt = seed & ok, torch.empty_like(ok)
    count = int(cur.sum())
    while True:
        for _ in range(check_every):
            _dilate(cur, ok, nxt)
            cur, nxt = nxt, cur
        now = int(cur.sum())
        if now == count:
            return cur
        count = now


def percolation(phase_ok, direction):
    """(active mask, number of active cells) of the bool volume
    ``phase_ok`` along ``direction``."""
    n = phase_ok.shape[direction]
    face = torch.zeros_like(phase_ok)
    _plane(face, direction, 0).fill_(True)
    reach_in = _fill(phase_ok, face)
    face.zero_()
    _plane(face, direction, n - 1).fill_(True)
    active = _fill(reach_in, face)
    return active, int(active.sum())


def _neighbour_sum(x, w, periodic):
    """sum_f w_f x(neighbour_f); zero outside a clamped axis."""
    out = torch.zeros_like(x)
    for a in range(3):
        n = x.shape[a]
        if periodic[a]:
            out += w[a] * (torch.roll(x, 1, a) + torch.roll(x, -1, a))
        elif n > 1:
            out.narrow(a, 0, n - 1).add_(x.narrow(a, 1, n - 1), alpha=w[a])
            out.narrow(a, 1, n - 1).add_(x.narrow(a, 0, n - 1), alpha=w[a])
    return out


def tortuosity(active, n_active, direction, vlo=-1.0, vhi=1.0,
               dx=(1.0, 1.0, 1.0), dtype=torch.float64, tol=TOL,
               maxiter=2000):
    """Flow-through tau of the percolation mask ``active``: a dict of
    ``tau``, ``flux_in``, ``flux_out``, ``flux_rel_diff``,
    ``flux_conserved``, ``active_vf``, ``iterations``, ``rel_res`` and
    ``converged``."""
    shape = tuple(active.shape)
    total = math.prod(shape)
    active_vf = n_active / total
    if n_active == 0:
        return dict(tau=math.nan, flux_in=0.0, flux_out=0.0,
                    flux_rel_diff=math.nan, flux_conserved=False,
                    active_vf=active_vf, iterations=0, rel_res=math.nan,
                    converged=False)
    w = _weights(dx)
    periodic = (False, False, False)
    dev = active.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    a_f = active.to(dtype)
    degree = _neighbour_sum(a_f, w, periodic)
    connected = active & (_neighbour_sum(a_f, (1.0, 1.0, 1.0), periodic) > 0)
    del a_f
    n = shape[direction]
    idx = torch.arange(n, device=dev).reshape(
        [-1 if a == direction else 1 for a in range(3)])
    on_lo = connected & (idx == 0)
    on_hi = connected & (idx == n - 1)
    free = connected & ~(on_lo | on_hi)
    fixed = torch.where(on_lo, torch.full((), vlo, dtype=dtype, device=dev),
                        zero)
    fixed = torch.where(on_hi, torch.full((), vhi, dtype=dtype, device=dev),
                        fixed)
    b = torch.where(free, _neighbour_sum(fixed, w, periodic), zero)
    op = Operator(torch.where(free, degree, zero),
                  conductances(free, w, periodic, dtype), free, periodic)
    del degree
    b_full = math.sqrt(vlo * vlo * int(on_lo.sum())
                       + vhi * vhi * int(on_hi.sum()))
    z, info = pcg(op, b, b_full, tol, maxiter, Multigrid.build(op))
    del op, b
    phi = fixed + z
    del z, fixed

    d = float(dx[direction])
    n_lo_in, n_hi_in = min(1, n - 1), max(n - 2, 0)
    m_lo = _plane(active, direction, 0) & _plane(active, direction, n_lo_in)
    m_hi = _plane(active, direction, n - 1) & _plane(active, direction,
                                                     n_hi_in)
    flux_in = float(torch.sum(torch.where(m_lo, -(
        _plane(phi, direction, n_lo_in) - _plane(phi, direction, 0)) / d,
        zero)))
    flux_out = float(torch.sum(torch.where(m_hi, -(
        _plane(phi, direction, n - 1) - _plane(phi, direction, n_hi_in)) / d,
        zero)))
    others = [a for a in range(3) if a != direction]
    area_el = float(dx[others[0]]) * float(dx[others[1]])
    flux_in, flux_out = flux_in * area_el, flux_out * area_el

    mag_in, mag_out = abs(flux_in), abs(flux_out)
    mag = 0.5 * (mag_in + mag_out)
    if mag > TINY_FLUX:
        rel_diff = abs(mag_in - mag_out) / mag
    else:
        rel_diff = 0.0
    conserved = rel_diff <= FLUX_TOL
    length = shape[direction] * d
    area = (shape[others[0]] * float(dx[others[0]])) * (
        shape[others[1]] * float(dx[others[1]]))
    grad = (vhi - vlo) / length
    if not conserved:
        tau = math.nan
    elif mag < TINY_FLUX or abs(grad) < TINY_FLUX:
        tau = math.inf
    else:
        deff = (mag / area) / abs(grad)
        tau = math.inf if abs(deff) < TINY_FLUX else active_vf / deff
    return dict(tau=tau, flux_in=flux_in, flux_out=flux_out,
                flux_rel_diff=rel_diff, flux_conserved=conserved,
                active_vf=active_vf, iterations=info.iterations,
                rel_res=info.rel_res, converged=info.converged)


def cell_problem(active, k, dx=(1.0, 1.0, 1.0), dtype=torch.float64,
                 tol=TOL, maxiter=2000, precond=None):
    """chi_k on the active cells (0 elsewhere), and the solve's info;
    ``precond``: a ``Multigrid`` of the operator, which ``k`` leaves
    alone."""
    zero = torch.zeros((), dtype=dtype, device=active.device)
    op = cell_operator(active, dx, dtype)
    m = active.to(dtype)
    mp, mm = torch.roll(m, -1, k), torch.roll(m, 1, k)
    d = float(dx[k])
    b = torch.where(active, -(mp - mm) / (2.0 * d) + (1.0 - mm) / d
                    - (1.0 - mp) / d, zero)
    del m, mp, mm
    scale = float(torch.linalg.vector_norm(b))
    return pcg(op, b, scale, tol, maxiter,
               precond if precond is not None else Multigrid.build(op))


def cell_operator(active, dx=(1.0, 1.0, 1.0), dtype=torch.float64):
    w = _weights(dx)
    periodic = (True, True, True)
    zero = torch.zeros((), dtype=dtype, device=active.device)
    diag = torch.where(active, torch.full((), 2.0 * sum(w), dtype=dtype,
                                          device=active.device), zero)
    return Operator(diag, conductances(active, w, periodic, dtype), active,
                    periodic)


def deff_tensor(active, dx=(1.0, 1.0, 1.0), dtype=torch.float64, tol=TOL,
                maxiter=2000):
    """(3x3 numpy D_eff, [SolveInfo] * 3) of the bool mask ``active``."""
    total = math.prod(active.shape)
    n_active = int(active.sum())
    if n_active == 0:
        return np.zeros((3, 3)), []
    mg = Multigrid.build(cell_operator(active, dx, dtype))
    zero = torch.zeros((), dtype=dtype, device=active.device)
    out = np.zeros((3, 3))
    infos = []
    for b_ax in range(3):
        chi, info = cell_problem(active, b_ax, dx, dtype, tol, maxiter, mg)
        infos.append(info)
        for a in range(3):
            grad = (torch.roll(chi, -1, a) - torch.roll(chi, 1, a)) / (
                2.0 * float(dx[a]))
            s = float(torch.sum(torch.where(active, grad, zero)))
            out[a, b_ax] = ((n_active if a == b_ax else 0.0) - s) / total
        del chi
    return out, infos


def rev_boxes(shape, sizes, num_samples, rng):
    """The REV study's crop boxes, drawn as upstream draws them
    (``Diffusion.cpp:344-361``): for each sample, for each size, an origin
    per axis uniform in ``[0, N - size]``, clipped to the volume, skipped
    when the longest side is under 8.  ``[(sample_no, size, origin,
    extent)]``."""
    boxes = []
    for s in range(int(num_samples)):
        for size in sizes:
            size = int(size)
            lo = [0 if n - size < 0 else int(rng.integers(0, n - size + 1))
                  for n in shape]
            ext = tuple(min(l + size, n) - l for l, n in zip(lo, shape))
            if max(ext) < 8:
                continue
            boxes.append((s + 1, size, tuple(lo), ext))
    return boxes

