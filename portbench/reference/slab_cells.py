"""The periodic cell problems and the D_eff tensor on X slabs spread over
several devices, in one process: ``props.cell_operator``,
``cell_problem`` and ``deff_tensor`` for a volume that no one device
holds in float64.

It keeps ``slabs.py``'s conventions: a field is a list of ``(X_k, Y, Z)``
tensors, slab ``k`` on device ``k`` and the slabs in X order; where a
stencil reaches across a slab's first or last plane, the neighbour slab's
plane is copied over (a ghost), and each face's term is applied in the
order of the one-device code; dot products, norms and counts are summed
per slab, then over the slabs in X order in float64.

Every axis is periodic.  Along X the first slab's low ghost is the last
slab's last plane and the last slab's high ghost is the first slab's
first plane; Y and Z roll within each slab.  The right-hand side's
neighbours along X and the tensor's central difference along X wrap the
same way.  The cycle is ``slabs.SlabMultigrid``'s on levels coarsened by
``slabs.coarsen`` (its arithmetic holds for a periodic operator: the last
plane's X face is the wrapped one), as deep as ``slabs.MAX_LEVELS``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .laplace import face_mask
from .props import TOL, _weights
from .slabs import (MAX_LEVELS, SlabMultigrid, SlabOperator, _count,
                    _norm, _total, coarsen, pcg)


def ghosts(f):
    """``(lo, hi)``: for each slab, the previous slab's last plane and the
    next slab's first plane, on its device, wrapping at the ends."""
    n = len(f)
    lo = [f[k - 1][-1].to(f[k].device) for k in range(n)]
    hi = [f[(k + 1) % n][0].to(f[k].device) for k in range(n)]
    return lo, hi


def _shifted(f, axis, step):
    """For each slab, the field at ``i + step`` along ``axis`` (``step``
    +1 or -1), wrapping: ``torch.roll(f, -step, axis)`` of the whole
    volume."""
    if axis:
        return [torch.roll(fk, -step, axis) for fk in f]
    lo, hi = ghosts(f)
    if step > 0:
        return [torch.cat([fk[1:], h.unsqueeze(0)]) for fk, h in zip(f, hi)]
    return [torch.cat([l.unsqueeze(0), fk[:-1]]) for fk, l in zip(f, lo)]


def _cx_lo(cond):
    """For each slab, the X conductance of the face it shares with the
    previous slab (that slab's last plane; the last slab's for the
    first), on its device."""
    return [cond[k - 1][0][-1:].to(cond[k][0].device)
            for k in range(len(cond))]


class PeriodicSlabOperator(SlabOperator):
    """``laplace.Operator`` with every axis periodic, on slabs."""

    def apply(self, z):
        lo, hi = ghosts(z)
        last = len(z) - 1
        out = []
        for k, zk in enumerate(z):
            y = self.diag[k] * zk
            cx, n = self.cond[k][0], zk.shape[0]
            # along X: each plane's +e and -e terms in the one-device
            # order, where the volume's last plane takes its wrapped +e
            # term after its -e term
            if n > 1:
                y.narrow(0, 0, n - 1).addcmul_(
                    cx.narrow(0, 0, n - 1), zk.narrow(0, 1, n - 1), value=-1)
            if k != last:
                y.narrow(0, n - 1, 1).addcmul_(
                    cx.narrow(0, n - 1, 1), hi[k].unsqueeze(0), value=-1)
            if n > 1:
                y.narrow(0, 1, n - 1).addcmul_(
                    cx.narrow(0, 0, n - 1), zk.narrow(0, 0, n - 1), value=-1)
            if k == last:
                y.narrow(0, n - 1, 1).addcmul_(
                    cx.narrow(0, n - 1, 1), hi[k].unsqueeze(0), value=-1)
            y.narrow(0, 0, 1).addcmul_(self.cx_lo[k], lo[k].unsqueeze(0),
                                       value=-1)
            for a in (1, 2):
                c, m = self.cond[k][a], zk.shape[a]
                if m > 1:
                    y.narrow(a, 0, m - 1).addcmul_(
                        c.narrow(a, 0, m - 1), zk.narrow(a, 1, m - 1),
                        value=-1)
                    y.narrow(a, 1, m - 1).addcmul_(
                        c.narrow(a, 0, m - 1), zk.narrow(a, 0, m - 1),
                        value=-1)
                wrap = c.narrow(a, m - 1, 1)
                y.narrow(a, m - 1, 1).addcmul_(wrap, zk.narrow(a, 0, 1),
                                               value=-1)
                y.narrow(a, 0, 1).addcmul_(wrap, zk.narrow(a, m - 1, 1),
                                           value=-1)
            out.append(y)
        return out


def _periodic(op):
    return PeriodicSlabOperator(op.diag, op.cond, op.free, _cx_lo(op.cond))


def multigrid(op: PeriodicSlabOperator, max_levels: int = MAX_LEVELS,
              min_extent: int = 8, **kw):
    """``SlabMultigrid.build`` on periodic levels (``coarsen`` reads only
    the levels' arrays, so each coarse level is wrapped once built)."""
    mg = SlabMultigrid.build(op, max_levels, min_extent, **kw)
    mg.levels[1:] = [_periodic(lv) for lv in mg.levels[1:]]
    return mg


def cell_operator(active, dx=(1.0, 1.0, 1.0), dtype=torch.float64):
    """``props.cell_operator`` of the bool slabs ``active``."""
    w = _weights(dx)
    _, hi = ghosts(active)
    diag, cond = [], []
    for m, h in zip(active, hi):
        dev = m.device
        diag.append(torch.where(m, torch.full((), 2.0 * sum(w), dtype=dtype,
                                              device=dev),
                                torch.zeros((), dtype=dtype, device=dev)))
        fx = m & torch.roll(m, -1, 0)
        fx[-1] = m[-1] & h
        cond.append((fx.to(dtype) * w[0],
                     face_mask(m, 1, True).to(dtype) * w[1],
                     face_mask(m, 2, True).to(dtype) * w[2]))
    return PeriodicSlabOperator(diag, cond, list(active), _cx_lo(cond))


def cell_problem(active, k, dx=(1.0, 1.0, 1.0), dtype=torch.float64,
                 tol=TOL, maxiter=2000, precond=None):
    """``props.cell_problem`` on slabs: chi_k's slabs and the solve's
    info; ``precond``: a ``multigrid`` of the operator (whose finest level
    is the operator), which ``k`` leaves alone."""
    mg = precond if precond is not None else multigrid(
        cell_operator(active, dx, dtype))
    m = [a.to(dtype) for a in active]
    mp, mm = _shifted(m, k, 1), _shifted(m, k, -1)
    d = float(dx[k])
    b = [torch.where(a, -(p - q) / (2.0 * d) + (1.0 - q) / d
                     - (1.0 - p) / d,
                     torch.zeros((), dtype=dtype, device=a.device))
         for a, p, q in zip(active, mp, mm)]
    del m, mp, mm
    return pcg(mg.levels[0], b, _norm(b), tol, maxiter, mg)


def deff_tensor(active, dx=(1.0, 1.0, 1.0), dtype=torch.float64, tol=TOL,
                maxiter=2000, max_levels=MAX_LEVELS):
    """``props.deff_tensor`` of the bool slabs ``active``: (3x3 numpy
    D_eff, [SolveInfo] * 3)."""
    shape = (sum(a.shape[0] for a in active),) + tuple(active[0].shape[1:])
    total = math.prod(shape)
    n_active = _count(active)
    if n_active == 0:
        return np.zeros((3, 3)), []
    mg = multigrid(cell_operator(active, dx, dtype), max_levels=max_levels)
    out = np.zeros((3, 3))
    infos = []
    for b_ax in range(3):
        chi, info = cell_problem(active, b_ax, dx, dtype, tol, maxiter, mg)
        infos.append(info)
        for a in range(3):
            parts = []
            for act, p, q in zip(active, _shifted(chi, a, 1),
                                 _shifted(chi, a, -1)):
                grad = (p - q) / (2.0 * float(dx[a]))
                parts.append(torch.sum(torch.where(
                    act, grad, torch.zeros((), dtype=dtype,
                                           device=act.device))))
            out[a, b_ax] = ((n_active if a == b_ax else 0.0)
                            - _total(parts)) / total
        del chi
    return out, infos
