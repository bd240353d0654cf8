"""Flow-through tau on X slabs spread over several devices, in one
process: the equations of ``props.py`` and the operators, cycle and
conjugate gradients of ``laplace.py``, for a volume that no one device
holds in float64.

A field is a list of ``(X_k, Y, Z)`` tensors, slab ``k`` on device ``k``
and the slabs in X order.  Where a stencil reaches across a slab's first
or last plane, the neighbour slab's plane is copied over (a ghost), and
each face's term is applied in the order of the one-device code, so that
every element gets the same arithmetic.  Dot products, norms and counts
are summed per slab, then over the slabs in X order in float64.  The
cycle coarsens each slab by 2x2x2 blocks: a slab's X extent must stay
even on every level but the coarsest.

Flow-through only, so every axis is clamped.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .laplace import SolveInfo, _block_sum, _pair_pick, _prolong, face_mask
from .props import FLUX_TOL, TINY_FLUX, TOL, _weights

# five levels: at 1024^3 the coarsest is 64^3, as four levels leave it at
# 512^3 (the one-device reference's depth)
MAX_LEVELS = 5


def split(volume, devices):
    """The X slabs of ``volume`` (numpy or a tensor), one on each of
    ``devices``, of equal extents."""
    n = len(devices)
    if volume.shape[0] % n:
        raise ValueError(f"X extent {volume.shape[0]} does not split into "
                         f"{n} equal slabs")
    step = volume.shape[0] // n
    return [torch.as_tensor(volume[k * step:(k + 1) * step]).to(d)
            for k, d in enumerate(devices)]


def _total(parts) -> float:
    """Per-slab scalars summed in slab order in float64."""
    s = 0.0
    for p in parts:
        s += float(p)
    return s


def _dot(a, b) -> float:
    return _total(torch.dot(x.flatten(), y.flatten()) for x, y in zip(a, b))


def _norm(a) -> float:
    return math.sqrt(_dot(a, a))


def _count(mask) -> int:
    return sum(int(m.sum()) for m in mask)


def ghosts(f):
    """``(lo, hi)``: for each slab, the previous slab's last plane and the
    next slab's first plane, on its device; None at the volume's ends."""
    n = len(f)
    lo = [None] + [f[k - 1][-1].to(f[k].device) for k in range(1, n)]
    hi = [f[k + 1][0].to(f[k].device) for k in range(n - 1)] + [None]
    return lo, hi


def _neighbour_sum(x, w):
    """``props._neighbour_sum`` on slabs (every axis clamped)."""
    lo, hi = ghosts(x)
    out = []
    for k, xk in enumerate(x):
        o = torch.zeros_like(xk)
        n = xk.shape[0]
        if n > 1:
            o.narrow(0, 0, n - 1).add_(xk.narrow(0, 1, n - 1), alpha=w[0])
        if hi[k] is not None:
            o.narrow(0, n - 1, 1).add_(hi[k].unsqueeze(0), alpha=w[0])
        if n > 1:
            o.narrow(0, 1, n - 1).add_(xk.narrow(0, 0, n - 1), alpha=w[0])
        if lo[k] is not None:
            o.narrow(0, 0, 1).add_(lo[k].unsqueeze(0), alpha=w[0])
        for a in (1, 2):
            m = xk.shape[a]
            if m > 1:
                o.narrow(a, 0, m - 1).add_(xk.narrow(a, 1, m - 1),
                                           alpha=w[a])
                o.narrow(a, 1, m - 1).add_(xk.narrow(a, 0, m - 1),
                                           alpha=w[a])
        out.append(o)
    return out


def _conductances(free, w, dtype):
    """Each slab's ``(c_x, c_y, c_z)``: ``laplace.conductances`` with the
    X face of a slab's last plane reaching into the next slab."""
    _, hi = ghosts(free)
    out = []
    for k, m in enumerate(free):
        fx = m & torch.roll(m, -1, 0)
        fx[-1] = m[-1] & hi[k] if hi[k] is not None else False
        out.append((fx.to(dtype) * w[0],
                    face_mask(m, 1, False).to(dtype) * w[1],
                    face_mask(m, 2, False).to(dtype) * w[2]))
    return out


def _cx_lo(cond):
    """For each slab, the X conductance of the face it shares with the
    previous slab (that slab's last plane), on its device."""
    return [None] + [cond[k - 1][0][-1:].to(cond[k][0].device)
                     for k in range(1, len(cond))]


@dataclasses.dataclass
class SlabOperator:
    """``laplace.Operator`` on slabs; ``cx_lo`` as ``_cx_lo`` gives."""

    diag: list
    cond: list
    free: list
    cx_lo: list

    @property
    def shape(self):
        return (sum(d.shape[0] for d in self.diag),) + tuple(
            self.diag[0].shape[1:])

    def apply(self, z):
        lo, hi = ghosts(z)
        out = []
        for k, zk in enumerate(z):
            y = self.diag[k] * zk
            cx, n = self.cond[k][0], zk.shape[0]
            # along X: every +e term before every -e term, as one device
            if n > 1:
                y.narrow(0, 0, n - 1).addcmul_(
                    cx.narrow(0, 0, n - 1), zk.narrow(0, 1, n - 1), value=-1)
            if hi[k] is not None:
                y.narrow(0, n - 1, 1).addcmul_(
                    cx.narrow(0, n - 1, 1), hi[k].unsqueeze(0), value=-1)
            if n > 1:
                y.narrow(0, 1, n - 1).addcmul_(
                    cx.narrow(0, 0, n - 1), zk.narrow(0, 0, n - 1), value=-1)
            if lo[k] is not None:
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
            out.append(y)
        return out


def coarsen(op: SlabOperator):
    """``laplace.coarsen`` slab by slab (the singular-block test against
    the largest diagonal of the whole level); None where a slab's extent
    is odd or 1."""
    if any(n % 2 or n < 2 for d in op.diag for n in d.shape):
        return None
    diags, conds = [], []
    for diag, cond in zip(op.diag, op.cond):
        diag = _block_sum(diag)
        coarse = []
        for a in range(3):
            others = [b for b in range(3) if b != a]
            inner = _block_sum(_pair_pick(cond[a], a, 0), others)
            diag = diag - 2.0 * inner
            coarse.append(_block_sum(_pair_pick(cond[a], a, 1), others))
        diags.append(diag)
        conds.append(tuple(coarse))
    top = max(max(float(d.abs().amax()) for d in diags), 1.0)
    free = [d > 1e-12 * top for d in diags]
    diags = [torch.where(f, d, torch.zeros((), dtype=d.dtype,
                                           device=d.device))
             for f, d in zip(free, diags)]
    return SlabOperator(diags, conds, free, _cx_lo(conds))


@dataclasses.dataclass
class SlabMultigrid:
    """``laplace.Multigrid`` on slabs, with the same cycle and defaults."""

    levels: list
    inv_diag: list
    omega: float = 0.8
    sweeps: int = 2
    coarse_sweeps: int = 40
    overcorrect: float = 1.8

    @classmethod
    def build(cls, op: SlabOperator, max_levels: int = MAX_LEVELS,
              min_extent: int = 8, **kw):
        levels = [op]
        while len(levels) < max_levels and min(
                levels[-1].shape) >= 2 * min_extent:
            nxt = coarsen(levels[-1])
            if nxt is None:
                break
            levels.append(nxt)
        inv = []
        for lv in levels:
            per = []
            for f, d in zip(lv.free, lv.diag):
                one = torch.ones((), dtype=d.dtype, device=d.device)
                per.append(torch.where(f, one / torch.where(f, d, one),
                                       torch.zeros_like(one)))
            inv.append(per)
        return cls(levels, inv, **kw)

    def _smooth(self, i, x, r, n):
        op, inv = self.levels[i], self.inv_diag[i]
        for _ in range(n):
            ax = op.apply(x)
            for xk, ik, rk, ak in zip(x, inv, r, ax):
                xk.addcmul_(ik, rk - ak, value=self.omega)
        return x

    def cycle(self, r, i=0):
        inv = self.inv_diag[i]
        last = i == len(self.levels) - 1
        x = [self.omega * ik * rk for ik, rk in zip(inv, r)]
        x = self._smooth(i, x, r, (self.coarse_sweeps if last
                                   else self.sweeps) - 1)
        if last:
            return x
        ax = self.levels[i].apply(x)
        rc = [_block_sum(rk - ak) for rk, ak in zip(r, ax)]
        del ax
        ec = self.cycle(rc, i + 1)
        for xk, ek, fk in zip(x, ec, self.levels[i].free):
            xk.add_(_prolong(ek, fk), alpha=self.overcorrect)
        return self._smooth(i, x, r, self.sweeps)

    __call__ = cycle


def pcg(op: SlabOperator, b, scale: float, tol: float, maxiter: int = 2000,
        precond=None, restarts: int = 3):
    """``laplace.pcg`` on slabs."""
    m = precond or (lambda r: r)
    x = [torch.zeros_like(bk) for bk in b]
    if scale == 0.0 or _norm(b) == 0.0:
        return x, SolveInfo(0, 0.0, True)
    its, stall = 0, 50
    for _ in range(restarts + 1):
        r = [bk - ak for bk, ak in zip(b, op.apply(x))]
        rn = _norm(r)
        if rn <= tol * scale:
            return x, SolveInfo(its, rn / scale, True)
        z = m(r)
        p = [zk.clone() for zk in z]
        rz = _dot(r, z)
        best, since = rn, 0
        while its < maxiter:
            ap = op.apply(p)
            alpha = rz / _dot(p, ap)
            for xk, rk, pk, ak in zip(x, r, p, ap):
                xk.add_(alpha * pk)
                rk.sub_(alpha * ak)
            del ap
            its += 1
            rn = _norm(r)
            if rn <= tol * scale:
                break
            if rn < 0.5 * best:
                best, since = rn, 0
            else:
                since += 1
                if since >= stall:
                    break
            z = m(r)
            rz_new = _dot(r, z)
            for pk, zk in zip(p, z):
                pk.mul_(rz_new / rz).add_(zk)
            rz = rz_new
        if its >= maxiter or since >= stall:
            break
    rn = _norm([bk - ak for bk, ak in zip(b, op.apply(x))])
    return x, SolveInfo(its, rn / scale, rn <= tol * scale)


def _dilate(cur, ok, out):
    """``props._dilate`` on slabs."""
    lo, hi = ghosts(cur)
    for k, (c, o) in enumerate(zip(cur, out)):
        o.copy_(c)
        n = c.shape[0]
        if n > 1:
            o.narrow(0, 0, n - 1).logical_or_(c.narrow(0, 1, n - 1))
            o.narrow(0, 1, n - 1).logical_or_(c.narrow(0, 0, n - 1))
        if hi[k] is not None:
            o[-1].logical_or_(hi[k])
        if lo[k] is not None:
            o[0].logical_or_(lo[k])
        for a in (1, 2):
            m = c.shape[a]
            if m > 1:
                o.narrow(a, 0, m - 1).logical_or_(c.narrow(a, 1, m - 1))
                o.narrow(a, 1, m - 1).logical_or_(c.narrow(a, 0, m - 1))
        o.logical_and_(ok[k])


def _fill(ok, seed, check_every=16):
    cur = [s & o for s, o in zip(seed, ok)]
    nxt = [torch.empty_like(o) for o in ok]
    count = _count(cur)
    while True:
        for _ in range(check_every):
            _dilate(cur, ok, nxt)
            cur, nxt = nxt, cur
        now = _count(cur)
        if now == count:
            return cur
        count = now


def _face(ok, direction, first: bool):
    """The inlet (``first``) or outlet plane along ``direction``."""
    face = [torch.zeros_like(o) for o in ok]
    if direction == 0:
        (face[0][0] if first else face[-1][-1]).fill_(True)
    else:
        for f in face:
            f.select(direction, 0 if first else f.shape[direction] - 1
                     ).fill_(True)
    return face


def percolation(phase_ok, direction):
    """``props.percolation`` of the bool slabs ``phase_ok``: (active slabs,
    number of active cells)."""
    reach_in = _fill(phase_ok, _face(phase_ok, direction, True))
    active = _fill(reach_in, _face(phase_ok, direction, False))
    del reach_in
    return active, _count(active)


def _planes(f, direction, index):
    """The global plane ``index`` along ``direction``: its part on each
    slab, or for X the one slab's plane."""
    if direction != 0:
        return [fk.select(direction, index) for fk in f]
    step = f[0].shape[0]
    return [f[index // step][index % step]]


def _face_flux(phi, active, direction, face, inner, d, zero):
    """sum over the face plane of ``-(phi[inner] - phi[face]) / d`` where
    both cells are active, slab by slab in X order."""
    parts = []
    for mf, mi, pf, pi in zip(_planes(active, direction, face),
                              _planes(active, direction, inner),
                              _planes(phi, direction, face),
                              _planes(phi, direction, inner)):
        dev = pf.device
        m = mf & mi.to(dev)
        parts.append(torch.sum(torch.where(m, -(pi.to(dev) - pf) / d,
                                           zero.to(dev))))
    return _total(parts)


def tortuosity(active, n_active, direction, vlo=-1.0, vhi=1.0,
               dx=(1.0, 1.0, 1.0), dtype=torch.float64, tol=TOL,
               maxiter=2000, max_levels=MAX_LEVELS):
    """``props.tortuosity`` of the percolation mask's slabs ``active``:
    the same dict."""
    shape = (sum(a.shape[0] for a in active),) + tuple(active[0].shape[1:])
    total = math.prod(shape)
    active_vf = n_active / total
    if n_active == 0:
        return dict(tau=math.nan, flux_in=0.0, flux_out=0.0,
                    flux_rel_diff=math.nan, flux_conserved=False,
                    active_vf=active_vf, iterations=0, rel_res=math.nan,
                    converged=False)
    w = _weights(dx)
    a_f = [a.to(dtype) for a in active]
    degree = _neighbour_sum(a_f, w)
    connected = [a & (s > 0) for a, s in zip(
        active, _neighbour_sum(a_f, (1.0, 1.0, 1.0)))]
    del a_f
    n = shape[direction]
    free, fixed, on_lo_n, on_hi_n = [], [], 0, 0
    x0 = 0
    for c in connected:
        dev = c.device
        if direction == 0:
            idx = torch.arange(x0, x0 + c.shape[0], device=dev)
        else:
            idx = torch.arange(n, device=dev)
        idx = idx.reshape([-1 if a == direction else 1 for a in range(3)])
        x0 += c.shape[0]
        on_lo = c & (idx == 0)
        on_hi = c & (idx == n - 1)
        on_lo_n += int(on_lo.sum())
        on_hi_n += int(on_hi.sum())
        free.append(c & ~(on_lo | on_hi))
        zero = torch.zeros((), dtype=dtype, device=dev)
        f = torch.where(on_lo, torch.full((), vlo, dtype=dtype, device=dev),
                        zero)
        fixed.append(torch.where(on_hi, torch.full((), vhi, dtype=dtype,
                                                   device=dev), f))
    del connected
    b = [torch.where(fr, s, torch.zeros((), dtype=dtype, device=s.device))
         for fr, s in zip(free, _neighbour_sum(fixed, w))]
    cond = _conductances(free, w, dtype)
    op = SlabOperator(
        [torch.where(fr, dg, torch.zeros((), dtype=dtype, device=dg.device))
         for fr, dg in zip(free, degree)], cond, free, _cx_lo(cond))
    del degree
    b_full = math.sqrt(vlo * vlo * on_lo_n + vhi * vhi * on_hi_n)
    z, info = pcg(op, b, b_full, tol, maxiter,
                  SlabMultigrid.build(op, max_levels=max_levels))
    del op, b
    phi = [fk + zk for fk, zk in zip(fixed, z)]
    del z, fixed

    d = float(dx[direction])
    zero = torch.zeros((), dtype=dtype)
    n_lo_in, n_hi_in = min(1, n - 1), max(n - 2, 0)
    flux_in = _face_flux(phi, active, direction, 0, n_lo_in, d, zero)
    # mirrored at the outlet: -(phi[n - 1] - phi[n - 2]) / d
    flux_out = _face_flux(phi, active, direction, n_hi_in, n - 1, d, zero)
    others = [a for a in range(3) if a != direction]
    area_el = float(dx[others[0]]) * float(dx[others[1]])
    flux_in, flux_out = flux_in * area_el, flux_out * area_el

    mag_in, mag_out = abs(flux_in), abs(flux_out)
    mag = 0.5 * (mag_in + mag_out)
    rel_diff = abs(mag_in - mag_out) / mag if mag > TINY_FLUX else 0.0
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
