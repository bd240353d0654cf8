"""Masked 7-point operators in face-conductance form, a multigrid cycle
built on them by aggregation, and preconditioned conjugate gradients.

An operator acts on the free cells only:

    (A z)_i = diag_i z_i - sum_a (c_a[i] z[i + e_a] + c_a[i - e_a] z[i - e_a])

where ``c_a[i]`` is the conductance of the face between cell ``i`` and
``i + e_a``: 0 unless both cells are free, and 0 on the last plane of a
clamped axis (a periodic axis keeps it: that face wraps to plane 0).
Every array is ``(X, Y, Z)`` in one dtype on one device.

The multigrid cycle only makes the solve fast; the answer is whatever
conjugate gradients converge to, to the tolerance asked for.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Operator:
    diag: torch.Tensor  # 0 off the free set
    cond: tuple  # (c_x, c_y, c_z)
    free: torch.Tensor  # bool
    periodic: tuple

    def apply(self, z):
        y = self.diag * z
        for a in range(3):
            c, n = self.cond[a], z.shape[a]
            if n > 1:
                y.narrow(a, 0, n - 1).addcmul_(
                    c.narrow(a, 0, n - 1), z.narrow(a, 1, n - 1), value=-1)
                y.narrow(a, 1, n - 1).addcmul_(
                    c.narrow(a, 0, n - 1), z.narrow(a, 0, n - 1), value=-1)
            if self.periodic[a]:
                last = c.narrow(a, n - 1, 1)
                y.narrow(a, n - 1, 1).addcmul_(last, z.narrow(a, 0, 1),
                                               value=-1)
                y.narrow(a, 0, 1).addcmul_(last, z.narrow(a, n - 1, 1),
                                           value=-1)
        return y


def face_mask(m, axis, periodic):
    """``m[i] & m[i + e_axis]`` (the face's two cells), False on the last
    plane of a clamped axis."""
    nxt = torch.roll(m, -1, axis)
    f = m & nxt
    if not periodic:
        f.narrow(axis, m.shape[axis] - 1, 1).zero_()
    return f


def conductances(free, w, periodic, dtype):
    return tuple(face_mask(free, a, periodic[a]).to(dtype) * w[a]
                 for a in range(3))


def _pair_sum(x, axis):
    n = x.shape[axis]
    return x.unflatten(axis, (n // 2, 2)).sum(axis + 1)


def _pair_pick(x, axis, parity):
    n = x.shape[axis]
    return x.unflatten(axis, (n // 2, 2)).select(axis + 1, parity)


def _block_sum(x, axes=(0, 1, 2)):
    for a in axes:
        x = _pair_sum(x, a)
    return x


def coarsen(op: Operator):
    """The Galerkin operator P^T A P for P the piecewise-constant
    prolongation from 2x2x2 blocks onto their free cells: again a
    face-conductance operator.  None where an extent is odd or 1."""
    if any(n % 2 or n < 2 for n in op.diag.shape):
        return None
    diag = _block_sum(op.diag)
    cond = []
    for a in range(3):
        others = [b for b in range(3) if b != a]
        inner = _block_sum(_pair_pick(op.cond[a], a, 0), others)
        diag = diag - 2.0 * inner  # faces inside a block
        cond.append(_block_sum(_pair_pick(op.cond[a], a, 1), others))
    # a block whose cells all float (no excess, no outer face) is singular
    free = diag > 1e-12 * diag.abs().amax().clamp(min=1.0)
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)
    diag = torch.where(free, diag, zero)
    return Operator(diag, tuple(cond), free, op.periodic)


def _prolong(ec, free):
    for a in range(3):
        ec = ec.repeat_interleave(2, dim=a)
    return torch.where(free, ec, torch.zeros((), dtype=ec.dtype,
                                             device=ec.device))


@dataclasses.dataclass
class Multigrid:
    """Symmetric V-cycle: ``sweeps`` damped-Jacobi sweeps before and after
    the coarse correction, ``coarse_sweeps`` on the coarsest level."""

    levels: list
    inv_diag: list
    omega: float = 0.8
    sweeps: int = 2
    coarse_sweeps: int = 40
    # piecewise-constant prolongation undershoots smooth errors; a fixed
    # scale of the coarse correction keeps the cycle symmetric
    overcorrect: float = 1.8

    @classmethod
    def build(cls, op: Operator, max_levels: int = 4, min_extent: int = 8,
              **kw):
        levels = [op]
        while len(levels) < max_levels and min(
                levels[-1].diag.shape) >= 2 * min_extent:
            nxt = coarsen(levels[-1])
            if nxt is None:
                break
            levels.append(nxt)
        inv = []
        for lv in levels:
            one = torch.ones((), dtype=lv.diag.dtype, device=lv.diag.device)
            inv.append(torch.where(lv.free, one / torch.where(
                lv.free, lv.diag, one), torch.zeros_like(one)))
        return cls(levels, inv, **kw)

    def _smooth(self, i, x, r, n):
        op, inv = self.levels[i], self.inv_diag[i]
        for _ in range(n):
            x.addcmul_(inv, r - op.apply(x), value=self.omega)
        return x

    def cycle(self, r, i=0):
        inv = self.inv_diag[i]
        last = i == len(self.levels) - 1
        x = self.omega * inv * r  # the first sweep from zero
        x = self._smooth(i, x, r, (self.coarse_sweeps if last
                                   else self.sweeps) - 1)
        if last:
            return x
        rc = _block_sum(r - self.levels[i].apply(x))
        x.add_(_prolong(self.cycle(rc, i + 1), self.levels[i].free),
               alpha=self.overcorrect)
        return self._smooth(i, x, r, self.sweeps)

    __call__ = cycle


@dataclasses.dataclass
class SolveInfo:
    iterations: int
    rel_res: float  # true residual over the scale given
    converged: bool


def pcg(op: Operator, b, scale: float, tol: float, maxiter: int = 2000,
        precond=None, restarts: int = 3):
    """Solve ``A z = b`` on the free set until the true residual
    ``||b - A z|| <= tol * scale``.  A solve that stops improving for
    ``stall`` iterations (what a low precision reaches) returns its best
    iterate, not converged."""
    m = precond or (lambda r: r)
    x = torch.zeros_like(b)
    if scale == 0.0 or float(torch.linalg.vector_norm(b)) == 0.0:
        return x, SolveInfo(0, 0.0, True)
    its, stall = 0, 50
    for _ in range(restarts + 1):
        r = b - op.apply(x)
        rn = float(torch.linalg.vector_norm(r))
        if rn <= tol * scale:
            return x, SolveInfo(its, rn / scale, True)
        z = m(r)
        p = z.clone()
        rz = torch.dot(r.flatten(), z.flatten())
        best, since = rn, 0
        while its < maxiter:
            ap = op.apply(p)
            alpha = rz / torch.dot(p.flatten(), ap.flatten())
            x.add_(alpha * p)
            r.sub_(alpha * ap)
            its += 1
            rn = float(torch.linalg.vector_norm(r))
            if rn <= tol * scale:
                break
            if rn < 0.5 * best:
                best, since = rn, 0
            else:
                since += 1
                if since >= stall:
                    break
            z = m(r)
            rz_new = torch.dot(r.flatten(), z.flatten())
            p.mul_(rz_new / rz).add_(z)
            rz = rz_new
        if its >= maxiter or since >= stall:
            break
    rn = float(torch.linalg.vector_norm(b - op.apply(x)))
    return x, SolveInfo(its, rn / scale, rn <= tol * scale)
