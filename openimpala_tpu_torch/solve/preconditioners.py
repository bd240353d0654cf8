"""Preconditioners of the main paths (counterpart of
``openimpala_tpu/solve/preconditioners.py``): identity, Jacobi, the
Chebyshev polynomial, and the Galerkin multigrid V-cycle with
piecewise-constant transfers and a Chebyshev coarse solve.

Each class is a frozen dataclass holding tensors; ``__call__`` applies
M^{-1} r.  Nothing here reads a device value back to the host, so a
V-cycle queues its work without a synchronisation.

Not ported yet (they raise ``NotImplementedError``): trilinear transfers
(``transfer="tri"``), the W-cycle (``cycle="w"``), the Chebyshev smoother
(``smoother="cheby"``) and the rediscretised ``MultigridPreconditioner``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops import stencil_cuda
from ..ops.stencil import (
    _full,
    _on_cpu,
    _zero,
    apply_code,
    apply_restricted,
    decode_code,
    residual_restrict,
    residual_restricted,
    smooth_sweep,
)

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    def __call__(self, r):
        return r


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """Diagonal scaling restricted to the free set."""

    diag: torch.Tensor
    free: torch.Tensor

    @classmethod
    def from_system(cls, system):
        return cls(diag=system.diag, free=system.free)

    def __call__(self, r):
        diag = self.diag.expand(r.shape).to(r.dtype)
        safe = torch.where(diag > 0, diag, 1.0)
        return torch.where(self.free, r / safe, _zero(r))


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Fixed-degree Chebyshev polynomial preconditioner on the
    Jacobi-scaled operator D^{-1}A (PETSc/hypre-style recurrence).

    M^{-1} = p_d(D^{-1}A) D^{-1} is a fixed SPD polynomial operator, so CG
    remains valid.  A Chebyshev step is one matvec and a few AXPYs with no
    reduction, so the polynomial replaces about ``degree`` outer CG
    iterations and their dot products.

    Spectrum interval: lambda_max(D^{-1}A) <= 2 by Gershgorin for both
    masked operators; ``hi`` is a slight over-estimate of that bound,
    ``lo = hi/ratio``: modes below ``lo`` are left for the outer CG.

    ``diag`` and ``free`` are (X, Y, Z), or (B, X, Y, Z) for a batch of
    systems that share ``w`` and ``periodic``; ``r`` has their shape.  The
    operator goes through ``apply_restricted``: kernel K5 (one volume) or
    K4 (a batch) on the card.
    """

    diag: torch.Tensor
    free: torch.Tensor
    w: tuple
    periodic: tuple
    degree: int = 8
    hi: float = 2.0
    ratio: float = 24.0

    @classmethod
    def from_system(cls, system, degree: int = 8, hi: float = 2.0,
                    ratio: float = 24.0):
        free = system.free
        return cls(diag=system.diag.expand(free.shape)
                   .to(system.r0_b.dtype).contiguous(),
                   free=free, w=system.w, periodic=system.periodic,
                   degree=int(degree), hi=float(hi), ratio=float(ratio))

    def _jacobi_parts(self, dtype):
        """(where D^{-1} acts, the divisor there) for ``_minv``."""
        return (self.free & (self.diag > 0),
                torch.where(self.diag > 0, self.diag, 1.0).to(dtype))

    def _minv(self, v, parts=None):
        """D^{-1} v: ``(free & diag > 0) ? v / diag : 0``."""
        ok, safe = parts or self._jacobi_parts(v.dtype)
        return torch.where(ok, v / safe, _zero(v))

    def _apply_A(self, v):
        return apply_restricted(v, self.diag, self.free, self.w,
                                self.periodic)

    def __call__(self, r):
        # the scalar recurrence (rho) runs on the host in the working
        # dtype, the values the JAX loop carries on the device, so no
        # device value is read back
        lo = self.hi / self.ratio
        theta = 0.5 * (self.hi + lo)
        delta = 0.5 * (self.hi - lo)
        sigma = theta / delta
        ft = _NP_FLOAT[r.dtype]
        parts = self._jacobi_parts(r.dtype)  # once per application
        d = self._minv(r, parts) * float(ft(1.0 / theta))
        z = d
        res = r
        two_sigma = ft(2.0 * sigma)
        two_over_delta = ft(2.0 / delta)
        rho = ft(1.0 / sigma)
        for _ in range(1, self.degree):
            res = res - self._apply_A(d)
            rho_new = ft(1.0) / (two_sigma - rho)
            d = (float(rho_new * rho) * d
                 + float(rho_new * two_over_delta) * self._minv(res, parts))
            z = z + d
            rho = rho_new
        return z


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """The fine level: the packed bf16 geometry and its operator (K1)."""

    code: torch.Tensor
    w: tuple
    periodic: tuple

    def decode(self, dtype):
        return decode_code(self.code, self.w, dtype)

    @property
    def free(self):
        return self.code > 0

    def apply(self, x):
        return apply_code(x, self.code, self.w, self.periodic)

    def sweep(self, x, r, omega: float):
        """One damped-Jacobi sweep (K1 sweep on the card)."""
        return smooth_sweep(x, r, self.code, self.w, self.periodic, omega)

    def resid(self, x, r):
        """free ? r - A x : 0 (K1 resid on the card)."""
        return residual_restricted(x, r, self.code, self.w, self.periodic)

    def resid_restrict(self, x, r):
        """blocksum_2x2x2(free ? r - A x : 0) (K1 restrict on the card)."""
        return residual_restrict(x, r, self.code, self.w, self.periodic)


# ---------------------------------------------------------------------------
# Galerkin multigrid: face-conductance coarse operators.  With piecewise-
# constant prolongation P and restriction R = P^T, R A P is exactly another
# 7-point face-conductance operator:
#
#   c_H(coarse face) = sum of the fine conductances crossing it
#   diag_H           = blocksum(diag_h - sum_f c_f) + sum of adjacent c_H
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConductanceLevel:
    """Variable-coefficient 7-point level: A x = diag*x - sum_f c_f x_nbr.

    ``cx[i,j,k]`` is the conductance between cells i and i+1 (mod X) along
    axis 0 (likewise cy/cz); on clamped axes the wrap entry [-1] is zero.
    ``apply``/``sweep`` launch kernel K2 for a CUDA tensor and run the roll
    form (``apply_plain``/``sweep_plain``) only for a CPU tensor.
    """

    diag: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor

    @property
    def free(self):
        return self.diag > 0

    def apply_plain(self, x):
        stencil_cuda.note_plain("k2_matvec", x)
        c = (self.cx, self.cy, self.cz)
        out = self.diag * x
        for ax in range(3):
            out = out - c[ax] * torch.roll(x, -1, dims=ax)
            out = out - torch.roll(c[ax] * x, 1, dims=ax)
        return torch.where(self.free, out, _zero(x))

    def sweep_plain(self, x, r, omega: float):
        stencil_cuda.note_plain("k2_sweep", x)
        free = self.free
        inv_d = torch.where(
            free,
            _full(omega, r.dtype, r.device)
            / torch.where(free, self.diag, 1.0),
            _zero(r),
        )
        return x + inv_d * (r - self.apply_plain(x))

    def apply(self, x):
        if _on_cpu(x):
            return self.apply_plain(x)
        return stencil_cuda.k2_conductance("matvec", x, None, self.cx,
                                           self.cy, self.cz, self.diag)

    def sweep(self, x, r, omega: float):
        if _on_cpu(x):
            return self.sweep_plain(x, r, omega)
        return stencil_cuda.k2_conductance("sweep", x, r, self.cx, self.cy,
                                           self.cz, self.diag, omega=omega)


def _pairsum(x, axis):
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // 2, 2]
    return x.reshape(shape).sum(dim=axis + 1)


def _pairsel(x, axis, parity: int):
    """x[..., parity::2, ...] along ``axis`` (contiguous result)."""
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // 2, 2]
    return x.reshape(shape).select(axis + 1, parity).contiguous()


def _blocksum_axes(x, axes):
    for ax in sorted(axes, reverse=True):
        x = _pairsum(x, ax)
    return x


def _prolong_pc_axes(xc, axes):
    for ax in axes:
        xc = torch.repeat_interleave(xc, 2, dim=ax)
    return xc


def fine_conductances(system) -> ConductanceLevel:
    """The fine StencilSystem as a ConductanceLevel (seeds the Galerkin
    coarsening; level-0 smoothing keeps the packed operator and K1)."""
    free = system.free
    dtype = system.r0_b.dtype
    f = free.to(dtype)
    cs = []
    for ax in range(3):
        c = f * torch.roll(f, -1, dims=ax) * system.w[ax]
        if not system.periodic[ax]:
            c.narrow(ax, c.shape[ax] - 1, 1).zero_()
        cs.append(c)
    diag = system.diag.expand(free.shape).to(dtype)
    diag = torch.where(free, diag, _zero(diag))
    return ConductanceLevel(diag=diag, cx=cs[0], cy=cs[1], cz=cs[2])


def galerkin_coarsen(level: ConductanceLevel,
                     axes: tuple = (0, 1, 2)) -> ConductanceLevel:
    """Galerkin coarsening by 2 along ``axes`` (semi-coarsening when a
    strict subset; reference TortuosityHypre.cpp:671-678).

    * coarsened axis a: c_H = the fine faces crossing each coarse plane
      (odd fine index along a), pooled over the other coarsened axes;
    * un-coarsened axis b: c_H = block-sum over the coarsened axes;
    * diag_H = blocksum(surplus) + sum of adjacent c_H.
    """
    c = (level.cx, level.cy, level.cz)
    zero = _zero(level.diag)
    surplus = level.diag - sum(
        ci + torch.roll(ci, 1, dims=ax) for ax, ci in enumerate(c))
    surplus_H = _blocksum_axes(torch.where(level.free, surplus, zero), axes)
    cH = []
    for ax, ci in enumerate(c):
        if ax in axes:
            pooled = ci
            for a in sorted((a for a in axes if a != ax), reverse=True):
                pooled = _pairsum(pooled, a)
            cH.append(_pairsel(pooled, ax, 1))
        else:
            cH.append(_blocksum_axes(ci, axes))
    diag_H = surplus_H + sum(
        ci + torch.roll(ci, 1, dims=ax) for ax, ci in enumerate(cH))
    diag_H = torch.where(diag_H > 0, diag_H, zero)
    return ConductanceLevel(diag=diag_H, cx=cH[0], cy=cH[1], cz=cH[2])


def _build_hierarchy(system, schedule: tuple):
    """All Galerkin conductance levels; ``schedule[k]`` is the tuple of axes
    coarsened between level k and level k+1 (level 0 = fine)."""
    cur = fine_conductances(system)
    levels = []
    for axes in schedule:
        cur = galerkin_coarsen(cur, axes)
        levels.append(cur)
    return tuple(levels)


@dataclasses.dataclass(frozen=True)
class GalerkinMGPreconditioner:
    """V-cycle on the Galerkin (face-conductance) hierarchy.

    Level 0 smooths with the packed fine operator (K1 sweep, K1 restrict or
    resid), deeper levels with ConductanceLevel (K2).  Damped-Jacobi
    smoothing with symmetric pre/post sweeps keeps the cycle a fixed
    symmetric operator, so it is a valid CG preconditioner.  The coarsest
    level takes one Chebyshev solve (``coarse_solver="cheby"``, degree and
    interval auto-scaled in ``from_system``) or ``coarse_sweeps`` Jacobi
    sweeps (``"jacobi"``).
    """

    fine: MGLevel
    levels: Tuple[ConductanceLevel, ...]
    nu1: int = 2
    nu2: int = 2
    omega: float = 0.9
    coarse_sweeps: int = 100
    smoother: str = "jacobi"
    transfer: str = "pc"
    cycle: str = "v"
    coarse_solver: str = "cheby"
    coarse_ratio: float = 4000.0
    schedule: tuple = ()

    # spacing-anisotropy gate for semi-coarsening, as a ratio of per-axis
    # h^2 = 1/w (the JAX package's SEMI_THRESHOLD)
    SEMI_THRESHOLD = 2.0

    def __post_init__(self):
        if self.smoother != "jacobi":
            raise NotImplementedError(
                f"smoother={self.smoother!r} is not ported; use 'jacobi'")
        if self.transfer != "pc":
            raise NotImplementedError(
                f"transfer={self.transfer!r} is not ported; use 'pc'")
        if self.cycle != "v":
            raise NotImplementedError(
                f"cycle={self.cycle!r} is not ported; use 'v'")
        if self.coarse_solver not in ("cheby", "jacobi"):
            raise ValueError(f"unknown coarse_solver {self.coarse_solver!r}")

    @staticmethod
    def _schedule_for(shape, w, max_levels: int):
        """Per-level coarsening axes (PFMG-style semi-coarsening): exactly
        ``max_levels - 1`` steps; under anisotropic spacing only axes within
        SEMI_THRESHOLD of the strongest coupling coarsen, except the last
        step, which coarsens every eligible axis."""
        tau = GalerkinMGPreconditioner.SEMI_THRESHOLD
        h2 = [1.0 / float(wi) for wi in w]
        lo = min(h2)
        h2 = [x / lo for x in h2]
        shape = list(shape)
        cap = max_levels - 1
        schedule = []
        while len(schedule) < cap:
            elig = [a for a in range(3) if shape[a] % 2 == 0 and shape[a] >= 8]
            if not elig:
                break
            if len(schedule) == cap - 1:
                axes = tuple(elig)  # final step: resolve all axes
            else:
                m = min(h2[a] for a in elig)
                axes = tuple(a for a in elig if h2[a] <= m * tau)
            schedule.append(axes)
            for a in axes:
                shape[a] //= 2
                h2[a] *= 4.0
        return tuple(schedule)

    @classmethod
    def from_system(cls, system, max_levels: int = 3, **kw):
        fine = MGLevel(code=system.code, w=system.w, periodic=system.periodic)
        schedule = kw.pop("schedule", None)
        if schedule is None:
            schedule = cls._schedule_for(tuple(system.code.shape), system.w,
                                         max_levels)
        schedule = tuple(tuple(a) for a in schedule)
        shape = list(system.code.shape)
        for axes in schedule:
            for a in axes:
                shape[a] //= 2
        levels = _build_hierarchy(system, schedule) if schedule else ()
        kw["schedule"] = schedule
        if kw.get("coarse_solver", "cheby") == "cheby":
            # auto-scale the Chebyshev coarse solve to the coarsest level's
            # condition number (kappa(D^-1 A) ~ 0.25 N^2) and pick the degree
            # for a ~0.04 error factor (exp(-2 d / sqrt(ratio)))
            coarsest = tuple(levels[-1].diag.shape) if levels else tuple(shape)
            kw.setdefault("coarse_ratio", max(64.0, 0.25 * max(coarsest) ** 2))
            kw.setdefault("coarse_sweeps",
                          max(30, round(1.6 * kw["coarse_ratio"] ** 0.5)))
        return cls(fine=fine, levels=levels, **kw)

    # -- smoothing ---------------------------------------------------------
    def _smooth(self, apply_fn, diag, free, x, r, n: int):
        inv_d = torch.where(
            free, _full(self.omega, r.dtype, r.device)
            / torch.where(diag > 0, diag, 1.0),
            _zero(r),
        )
        for _ in range(n):
            x = x + inv_d * (r - apply_fn(x))
        return x

    def _smooth_cheby(self, apply_fn, diag, free, x, r, degree: int,
                      ratio: float = 6.0):
        """Degree-``degree`` Chebyshev iteration on [hi/ratio, hi] of
        D^{-1}A.  The scalar recurrence (rho) runs on the host in the
        working dtype (the values the JAX loop carries on the device),
        so no device value is ever read back."""
        hi = 2.2
        lo = hi / ratio
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        ft = _NP_FLOAT[r.dtype]
        inv_d = torch.where(
            free & (diag > 0),
            1.0 / torch.where(diag > 0, diag, 1.0),
            _zero(r),
        )
        res = r - apply_fn(x)
        d = inv_d * res * float(ft(1.0 / theta))
        x = x + d
        two_sigma = ft(2.0 * sigma)
        two_over_delta = ft(2.0 / delta)
        rho = ft(1.0 / sigma)
        for _ in range(1, degree):
            res = res - apply_fn(d)
            rho_new = ft(1.0) / (two_sigma - rho)
            d = (float(rho_new * rho) * d
                 + float(rho_new * two_over_delta) * (inv_d * res))
            x = x + d
            rho = rho_new
        return x

    def _fine_smooth(self, x, r, n: int):
        """``n`` damped-Jacobi sweeps on the fine level; ``x=None`` starts
        from zero, where the first sweep is the elementwise
        ``(omega/diag) * r``."""
        fine = self.fine
        if x is None:
            diag, free = fine.decode(r.dtype)
            inv_d = torch.where(
                free & (diag > 0),
                _full(self.omega, r.dtype, r.device)
                / torch.where(diag > 0, diag, 1.0),
                _zero(r),
            )
            x = inv_d * r
            n -= 1
        for _ in range(n):
            x = fine.sweep(x, r, self.omega)
        return x

    def _vcycle(self, idx: int, r):
        # idx 0 = fine (MGLevel); idx >= 1 = self.levels[idx-1]
        if idx == 0:
            if not self.levels:  # volume too small to coarsen at all
                diag, free = self.fine.decode(r.dtype)
                if self.coarse_solver == "cheby":
                    return self._smooth_cheby(self.fine.apply, diag, free,
                                              torch.zeros_like(r), r,
                                              self.coarse_sweeps,
                                              ratio=self.coarse_ratio)
                return self._smooth(self.fine.apply, diag, free,
                                    torch.zeros_like(r), r,
                                    self.coarse_sweeps)
            x = self._fine_smooth(None, r, self.nu1)
            if self._axes(0) != (0, 1, 2):
                # semi-coarsened first level: resid, then block-sum over
                # the coarsened axes only
                rc = _blocksum_axes(self.fine.resid(x, r), self._axes(0))
            else:
                # rc = blocksum(free ? r - A x : 0) in one pass (R = P^T)
                rc = self.fine.resid_restrict(x, r)
            ec = self._vcycle(1, rc)
            x = x + torch.where(self.fine.free, self._prolong(ec, 0),
                                _zero(r))
            return self._fine_smooth(x, r, self.nu2)

        lvl = self.levels[idx - 1]
        diag, free = lvl.diag.to(r.dtype), lvl.free

        if idx == len(self.levels):  # coarsest
            x = torch.zeros_like(r)
            if self.coarse_solver == "cheby":
                return self._smooth_cheby(lvl.apply, diag, free, x, r,
                                          self.coarse_sweeps,
                                          ratio=self.coarse_ratio)
            return self._smooth(lvl.apply, diag, free, x, r,
                                self.coarse_sweeps)

        x = self._cond_smooth(lvl, diag, free, None, r, self.nu1)
        resid = torch.where(free, r - lvl.apply(x), _zero(r))
        rc = _blocksum_axes(resid, self._axes(idx))  # R = P^T (sum)
        rc = torch.where(self.levels[idx].free, rc, _zero(r))
        ec = self._vcycle(idx + 1, rc)
        x = x + torch.where(free, self._prolong(ec, idx), _zero(r))
        return self._cond_smooth(lvl, diag, free, x, r, self.nu2)

    def _axes(self, idx: int) -> tuple:
        """Axes coarsened between level ``idx`` and ``idx + 1``."""
        return self.schedule[idx] if idx < len(self.schedule) else (0, 1, 2)

    def _prolong(self, ec, idx: int):
        return _prolong_pc_axes(ec, self._axes(idx))

    def _cond_smooth(self, lvl, diag, free, x, r, n: int):
        """Coarse-level damped-Jacobi sweeps (K2 sweep on the card);
        ``x=None`` starts from zero with the elementwise first sweep."""
        if x is None:
            inv_d = torch.where(
                free,
                _full(self.omega, r.dtype, r.device)
                / torch.where(free, diag, 1.0),
                _zero(r),
            )
            x = inv_d * r
            n -= 1
        for _ in range(n):
            x = lvl.sweep(x, r, self.omega)
        return x

    def __call__(self, r):
        return self._vcycle(0, r)
