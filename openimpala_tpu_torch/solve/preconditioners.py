"""Preconditioners (counterpart of
``openimpala_tpu/solve/preconditioners.py``): identity, Jacobi, the
Chebyshev polynomial, the Galerkin multigrid cycle (piecewise-constant or
trilinear transfers, V- or W-cycle, damped-Jacobi or Chebyshev smoothing,
a Chebyshev or Jacobi coarse solve) and the rediscretised-mask
``MultigridPreconditioner`` (``precond="mg"``).

Each class is a frozen dataclass holding tensors; ``__call__`` applies
M^{-1} r.  Nothing here reads a device value back to the host, so a
cycle queues its work without a synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops import stencil_cuda
from ..parallel.halo import pad_x, roll_x
from ..ops.stencil import (
    _full,
    _minus_one_bf16,
    _on_cpu,
    _zero,
    apply_code,
    apply_restricted,
    apply_restricted_slab,
    decode_code,
    pack_code_for,
    residual_restrict,
    residual_restricted,
    smooth_sweep,
    uniform_w,
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

    On an X slab (a system with a ``mesh``) ``diag`` and ``free`` are the
    slab's, and ``diag_halo``/``free_halo`` the same padded once by a
    plane of 0 on each side: the operator is ``apply_restricted_slab``
    (K5 on the slab padded by one exchanged plane, the wrap across the
    seam where X is periodic).  The recurrence is elementwise, with no
    reduction, so it is unchanged.
    """

    diag: torch.Tensor
    free: torch.Tensor
    w: tuple
    periodic: tuple
    degree: int = 8
    hi: float = 2.0
    ratio: float = 24.0
    mesh: object = None
    diag_halo: torch.Tensor = None
    free_halo: torch.Tensor = None

    @classmethod
    def from_system(cls, system, degree: int = 8, hi: float = 2.0,
                    ratio: float = 24.0):
        free = system.free
        diag = system.diag.expand(free.shape).to(system.r0_b.dtype) \
            .contiguous()
        mesh = getattr(system, "mesh", None)
        halos = {} if mesh is None else dict(
            mesh=mesh, diag_halo=pad_x(diag), free_halo=pad_x(free))
        return cls(diag=diag, free=free, w=system.w,
                   periodic=system.periodic, degree=int(degree),
                   hi=float(hi), ratio=float(ratio), **halos)

    def _jacobi_parts(self, dtype):
        """(where D^{-1} acts, the divisor there) for ``_minv``."""
        return (self.free & (self.diag > 0),
                torch.where(self.diag > 0, self.diag, 1.0).to(dtype))

    def _minv(self, v, parts=None):
        """D^{-1} v: ``(free & diag > 0) ? v / diag : 0``."""
        ok, safe = parts or self._jacobi_parts(v.dtype)
        return torch.where(ok, v / safe, _zero(v))

    def _apply_A(self, v):
        if self.mesh is not None:
            return apply_restricted_slab(v, self.diag_halo, self.free_halo,
                                         self.w, self.periodic, self.mesh)
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
    """A level held as packed bf16 geometry and its operator (K1): the
    fine level of every cycle, and every level of ``precond="mg"``."""

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


def _can_coarsen(shape):
    return all(s % 2 == 0 and s >= 8 for s in shape)


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
    ``apply``/``sweep``/``cheby_init``/``cheby_step`` launch kernel K2 for
    a CUDA tensor and run the roll form (``apply_plain``/``sweep_plain``/
    ``cheby_init_plain``/``cheby_step_plain``) only for a CPU tensor.
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

    def _inv_d_plain(self, dtype):
        diag = self.diag.to(dtype)
        return torch.where(self.free & (diag > 0),
                           1.0 / torch.where(diag > 0, diag, 1.0),
                           _zero(diag))

    def cheby_init_plain(self, r, c0: float):
        stencil_cuda.note_plain("k2_cheby_init", r)
        d = self._inv_d_plain(r.dtype) * r * c0
        return r.clone(), d, _zero(r) + d

    def cheby_step_plain(self, res, d, x, c1: float, c2: float):
        stencil_cuda.note_plain("k2_cheby", res)
        res = res - self.apply_plain(d)
        d = c1 * d + c2 * (self._inv_d_plain(res.dtype) * res)
        return res, d, x + d

    def apply(self, x):
        if _on_cpu(x):
            return self.apply_plain(x)
        return stencil_cuda.k2_conductance("matvec", x, None, self.cx,
                                           self.cy, self.cz, self.diag)

    def cheby_init(self, r, c0: float):
        """The Chebyshev iteration's first step from x = 0: ``(res, d, x)
        = (r, inv_d*r*c0, d)``, ``inv_d = diag > 0 ? 1/diag : 0``."""
        if _on_cpu(r):
            return self.cheby_init_plain(r, c0)
        return stencil_cuda.k2_cheby_init(r, self.diag, c0)

    def cheby_step(self, res, d, x, c1: float, c2: float, out=None):
        """One later step: ``res - A d``, ``d' = c1*d + c2*inv_d*res'``,
        ``x + d'``, returned as ``(res', d', x')``.  On the card one K2
        launch that updates ``res`` and ``x`` in place and writes ``d'``
        into ``out`` (a spare buffer like ``d``; new when None)."""
        if _on_cpu(res):
            return self.cheby_step_plain(res, d, x, c1, c2)
        d_new = stencil_cuda.k2_cheby(d, res, x, self.cx, self.cy, self.cz,
                                      self.diag, c1, c2, out=out)
        return res, d_new, x

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


# --- trilinear (cell-centred) transfers: per-axis weights 3/4, 1/4, with
# the exact transpose as restriction (weight sum 2 per coarse cell, the PC
# block-sum scaling the conductance operators are built for).  Plain tensor
# code around K1 resid and K2, as in the JAX package.


def _edge(t, axis, last: bool):
    """The first or last plane of ``t`` along ``axis`` (a view)."""
    return t.narrow(axis, t.shape[axis] - 1 if last else 0, 1)


def _prolong_tri_axis(e, axis, periodic: bool):
    """One axis of cell-centred trilinear prolongation (nc -> 2nc): even
    fine = 3/4 e_i + 1/4 e_{i-1}; odd fine = 3/4 e_i + 1/4 e_{i+1}; clamped
    axes fold the out-of-domain weight onto the edge cell."""
    lo = torch.roll(e, 1, dims=axis)  # e_{i-1}
    hi = torch.roll(e, -1, dims=axis)  # e_{i+1}
    if not periodic:
        _edge(lo, axis, False).copy_(_edge(e, axis, False))
        _edge(hi, axis, True).copy_(_edge(e, axis, True))
    st = torch.stack([0.75 * e + 0.25 * lo, 0.75 * e + 0.25 * hi],
                     dim=axis + 1)
    shape = list(e.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def _restrict_tri_axis(f, axis, periodic: bool):
    """Exact transpose of ``_prolong_tri_axis`` (2nc -> nc)."""
    ev = _pairsel(f, axis, 0)
    od = _pairsel(f, axis, 1)
    od_m1 = torch.roll(od, 1, dims=axis)  # od_{i-1}
    ev_p1 = torch.roll(ev, -1, dims=axis)  # ev_{i+1}
    if not periodic:
        # transpose of the clamped fold-in: zero the wrapped plane, then
        # credit the folded weight to the edge coarse cells
        _edge(od_m1, axis, False).zero_()
        lo_fix = 0.25 * _edge(ev, axis, False)
        _edge(ev_p1, axis, True).zero_()
        hi_fix = 0.25 * _edge(od, axis, True)
    out = 0.75 * (ev + od) + 0.25 * (od_m1 + ev_p1)
    if not periodic:
        _edge(out, axis, False).add_(lo_fix)
        _edge(out, axis, True).add_(hi_fix)
    return out


def _prolong_tri(xc, periodic):
    for ax in range(3):
        xc = _prolong_tri_axis(xc, ax, periodic[ax])
    return xc


def _restrict_tri(xf, periodic):
    for ax in range(3):
        xf = _restrict_tri_axis(xf, ax, periodic[ax])
    return xf


def _roll(x, shift: int, ax: int, mesh=None):
    """``torch.roll`` along ``ax``; along X under a ``mesh``, of the global
    array, on slabs (``parallel.halo.roll_x``)."""
    if ax == 0 and mesh is not None:
        return roll_x(x, shift, mesh)
    return torch.roll(x, shift, dims=ax)


def fine_conductances(system, mesh=None) -> ConductanceLevel:
    """The fine StencilSystem as a ConductanceLevel (seeds the Galerkin
    coarsening; level-0 smoothing keeps the packed operator and K1).
    Under a ``mesh``, this rank's slab: the conductance across the seam to
    the next rank is the slab's last X plane."""
    free = system.free
    dtype = system.r0_b.dtype
    f = free.to(dtype)
    cs = []
    for ax in range(3):
        c = f * _roll(f, -1, ax, mesh) * system.w[ax]
        if not system.periodic[ax] and (
                ax != 0 or mesh is None or mesh.rank == mesh.size - 1):
            c.narrow(ax, c.shape[ax] - 1, 1).zero_()
        cs.append(c)
    diag = system.diag.expand(free.shape).to(dtype)
    diag = torch.where(free, diag, _zero(diag))
    return ConductanceLevel(diag=diag, cx=cs[0], cy=cs[1], cz=cs[2])


def galerkin_coarsen(level: ConductanceLevel, axes: tuple = (0, 1, 2),
                     mesh=None) -> ConductanceLevel:
    """Galerkin coarsening by 2 along ``axes`` (semi-coarsening when a
    strict subset; reference TortuosityHypre.cpp:671-678).

    * coarsened axis a: c_H = the fine faces crossing each coarse plane
      (odd fine index along a), pooled over the other coarsened axes;
    * un-coarsened axis b: c_H = block-sum over the coarsened axes;
    * diag_H = blocksum(surplus) + sum of adjacent c_H.

    Under a ``mesh`` the level is this rank's X slab (an even number of
    planes where X coarsens): the conductance entering each slab comes
    from the previous rank.
    """
    c = (level.cx, level.cy, level.cz)
    zero = _zero(level.diag)
    surplus = level.diag - sum(
        ci + _roll(ci, 1, ax, mesh) for ax, ci in enumerate(c))
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
        ci + _roll(ci, 1, ax, mesh) for ax, ci in enumerate(cH))
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
    """Multigrid cycle on the Galerkin (face-conductance) hierarchy.

    Level 0 smooths with the packed fine operator (K1 sweep, K1 restrict or
    resid; K1 matvec under the Chebyshev smoother), deeper levels with
    ConductanceLevel (K2).  Symmetric pre/post smoothing keeps the cycle a
    fixed symmetric operator, so it is a valid CG preconditioner.

    ``smoother``: ``"jacobi"`` (damped Jacobi) or ``"cheby"`` (a
    degree-``nu`` Chebyshev polynomial on [2.2/6, 2.2] of D^-1 A).
    ``transfer``: ``"pc"`` (piecewise constant, R = P^T block sum) or
    ``"tri"`` (cell-centred trilinear; needs full coarsening).  ``cycle``:
    ``"v"``, or ``"w"``, which visits each level down to ``w_depth`` twice.
    The coarsest level takes one Chebyshev solve (``coarse_solver=
    "cheby"``, degree and interval auto-scaled in ``from_system``) or
    ``coarse_sweeps`` smoothing steps (``"jacobi"``).
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
    w_depth: int = 2
    coarse_solver: str = "cheby"
    coarse_ratio: float = 4000.0
    schedule: tuple = ()

    # spacing-anisotropy gate for semi-coarsening, as a ratio of per-axis
    # h^2 = 1/w (the JAX package's SEMI_THRESHOLD)
    SEMI_THRESHOLD = 2.0

    def __post_init__(self):
        for name, allowed in (("smoother", ("jacobi", "cheby")),
                              ("transfer", ("pc", "tri")),
                              ("cycle", ("v", "w")),
                              ("coarse_solver", ("cheby", "jacobi"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"expected one of {allowed}")

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
        if kw.get("transfer") == "tri" and any(
                a != (0, 1, 2) for a in schedule):
            raise ValueError(
                "transfer='tri' requires full coarsening at every level; "
                f"the derived schedule {schedule} semi-coarsens (anisotropic "
                "spacing) — use the default 'pc' transfers")
        levels = _build_hierarchy(system, schedule) if schedule else ()
        kw["schedule"] = schedule
        cls._coarse_defaults(kw, shape)
        return cls(fine=fine, levels=levels, **kw)

    @staticmethod
    def _coarse_defaults(kw: dict, coarsest):
        """Auto-scale the Chebyshev coarse solve to the coarsest level's
        condition number (kappa(D^-1 A) ~ 0.25 N^2, ``coarsest`` its
        global shape) and pick the degree for a ~0.04 error factor
        (exp(-2 d / sqrt(ratio))); an explicit option wins."""
        if kw.get("coarse_solver", "cheby") == "cheby":
            kw.setdefault("coarse_ratio", max(64.0, 0.25 * max(coarsest) ** 2))
            kw.setdefault("coarse_sweeps",
                          max(30, round(1.6 * kw["coarse_ratio"] ** 0.5)))

    # -- smoothing ---------------------------------------------------------
    def _smooth(self, lvl, diag, free, r, n: int):
        """``n`` smoothing steps on level ``lvl`` from zero."""
        if self.smoother == "cheby":
            return self._smooth_cheby(lvl, diag, free, None, r, n)
        inv_d = torch.where(
            free, _full(self.omega, r.dtype, r.device)
            / torch.where(diag > 0, diag, 1.0),
            _zero(r),
        )
        x = torch.zeros_like(r)
        for _ in range(n):
            x = x + inv_d * (r - lvl.apply(x))
        return x

    def _smooth_cheby(self, lvl, diag, free, x, r, degree: int,
                      ratio: float = 6.0):
        """Degree-``degree`` Chebyshev iteration on [hi/ratio, hi] of
        D^{-1}A on level ``lvl`` from ``x`` (None: from zero).  The scalar
        recurrence (rho) runs on the host in the working dtype (the values
        the JAX loop carries on the device), so no device value is ever
        read back.  On a ConductanceLevel each step is one
        ``lvl.cheby_step`` (one K2 launch on the card, which updates the
        loop's own ``res`` and ``x`` in place), and the step from zero one
        ``lvl.cheby_init``; so from zero on a slab level that has the pair
        (``solve/slab_mg.py``, padded buffers); other levels apply the
        operator and update with tensor code."""
        hi = 2.2
        lo = hi / ratio
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        ft = _NP_FLOAT[r.dtype]
        c0 = float(ft(1.0 / theta))
        fused = isinstance(lvl, ConductanceLevel) or (
            x is None and hasattr(lvl, "cheby_step"))
        if fused and x is None:
            res, d, x = lvl.cheby_init(r, c0)
        else:
            inv_d = torch.where(
                free & (diag > 0),
                1.0 / torch.where(diag > 0, diag, 1.0),
                _zero(r),
            )
            x = torch.zeros_like(r) if x is None else x
            res = r - lvl.apply(x)
            d = inv_d * res * c0
            x = x + d
        two_sigma = ft(2.0 * sigma)
        two_over_delta = ft(2.0 / delta)
        rho = ft(1.0 / sigma)
        spare = None  # the card's step writes d' beside d, then they swap
        for _ in range(1, degree):
            rho_new = ft(1.0) / (two_sigma - rho)
            c1 = float(rho_new * rho)
            c2 = float(rho_new * two_over_delta)
            if fused:
                res, d_new, x = lvl.cheby_step(res, d, x, c1, c2, out=spare)
                spare, d = d, d_new
            else:
                res = res - lvl.apply(d)
                d = c1 * d + c2 * (inv_d * res)
                x = x + d
            rho = rho_new
        return x

    def _fine_smooth(self, x, r, n: int):
        """``n`` damped-Jacobi sweeps on the fine level (K1 sweep);
        ``x=None`` starts from zero, where the first sweep is the
        elementwise ``(omega/diag) * r``.  The Chebyshev smoother applies
        the operator instead (K1 matvec)."""
        fine = self.fine
        if self.smoother == "cheby":
            diag, free = fine.decode(r.dtype)
            return self._smooth_cheby(fine, diag, free, x, r, n)
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
                    return self._smooth_cheby(self.fine, diag, free, None, r,
                                              self.coarse_sweeps,
                                              ratio=self.coarse_ratio)
                return self._smooth(self.fine, diag, free, r,
                                    self.coarse_sweeps)
            x = self._fine_smooth(None, r, self.nu1)
            if self.transfer == "tri":
                # K1 resid, then the trilinear restriction as tensor code
                rc = _restrict_tri(self.fine.resid(x, r), self.fine.periodic)
            elif self._axes(0) != (0, 1, 2):
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
            if self.coarse_solver == "cheby":
                return self._smooth_cheby(lvl, diag, free, None, r,
                                          self.coarse_sweeps,
                                          ratio=self.coarse_ratio)
            return self._smooth(lvl, diag, free, r, self.coarse_sweeps)

        x = self._cond_smooth(lvl, diag, free, None, r, self.nu1)
        # the W-cycle corrects twice on the levels down to w_depth
        n_corr = 2 if (self.cycle == "w" and idx <= self.w_depth) else 1
        for _ in range(n_corr):
            resid = torch.where(free, r - lvl.apply(x), _zero(r))
            if self.transfer == "tri":
                rc = _restrict_tri(resid, self.fine.periodic)
            else:
                rc = _blocksum_axes(resid, self._axes(idx))  # R = P^T (sum)
            rc = torch.where(self.levels[idx].free, rc, _zero(r))
            ec = self._vcycle(idx + 1, rc)
            x = x + torch.where(free, self._prolong(ec, idx), _zero(r))
        return self._cond_smooth(lvl, diag, free, x, r, self.nu2)

    def _axes(self, idx: int) -> tuple:
        """Axes coarsened between level ``idx`` and ``idx + 1``."""
        return self.schedule[idx] if idx < len(self.schedule) else (0, 1, 2)

    def _prolong(self, ec, idx: int):
        if self.transfer == "tri":
            return _prolong_tri(ec, self.fine.periodic)
        return _prolong_pc_axes(ec, self._axes(idx))

    def _cond_smooth(self, lvl, diag, free, x, r, n: int):
        """Coarse-level damped-Jacobi sweeps (K2 sweep on the card);
        ``x=None`` starts from zero with the elementwise first sweep.  The
        Chebyshev smoother runs K2's cheby steps (K2 matvec for the first
        residual of a nonzero ``x``)."""
        if self.smoother == "cheby":
            return self._smooth_cheby(lvl, diag, free, x, r, n)
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


# ---------------------------------------------------------------------------
# Rediscretised-mask geometric multigrid (the "mg" preconditioner; stands in
# for Hypre SMG/PFMG, reference TortuosityHypre.cpp:671-678).  Coarsening by
# 2 in all axes while every extent is even and >= 8; a coarse cell is free if
# ANY of its 2x2x2 children is free, and its code is rediscretised on the
# coarse mask with w/4 per level; full-weighting restriction, piecewise-
# constant prolongation, damped-Jacobi smoothing with symmetric pre/post
# counts.  Every level is an MGLevel, so on the card every level runs K1:
# sweep on all of them, restrict on all but the coarsest.
# ---------------------------------------------------------------------------


def _pairany(m, axis):
    shape = list(m.shape)
    shape[axis:axis + 1] = [shape[axis] // 2, 2]
    return m.reshape(shape).any(dim=axis + 1)


def _restrict(x):
    """Full weighting: the 2x2x2 block mean."""
    return _blocksum_axes(x, (0, 1, 2)) * 0.125


def _prolong(xc):
    return _prolong_pc_axes(xc, (0, 1, 2))


def _coarsen_free(free):
    return _pairany(_pairany(_pairany(free, 2), 1), 0)


def mg_depth(shape, max_levels: int) -> int:
    """How many coarse levels ``MultigridPreconditioner.from_system``
    builds below a fine level of ``shape``."""
    n, shape = 0, tuple(shape)
    while n + 1 < max_levels and _can_coarsen(shape):
        n, shape = n + 1, tuple(s // 2 for s in shape)
    return n


def mg_code(free, w, periodic, mesh=None):
    """A coarse level's code on its free set: the periodic cell problem's
    constant (every face counts), else rediscretised by counting the free
    neighbours on the coarse mask (under a ``mesh``, of this rank's slab,
    across the seams)."""
    if periodic[0]:  # cell problem: all-periodic
        code_free = 6 if uniform_w(w) else 2 * 16 + 2 * 4 + 2
        return torch.where(free, _full(code_free, torch.bfloat16,
                                       free.device),
                           _minus_one_bf16(free.device))
    return pack_code_for(w, free, free, periodic, mesh)


@dataclasses.dataclass(frozen=True)
class MultigridPreconditioner:
    """Geometric multigrid V-cycle on rediscretised masks.

    ``levels`` is a tuple of MGLevel from fine to coarse; smoothing is
    damped Jacobi (K1 sweep) with symmetric pre/post counts, so the cycle
    is a fixed symmetric operator and PCG stays valid.
    """

    levels: Tuple[MGLevel, ...]
    nu1: int = 2
    nu2: int = 2
    omega: float = 0.8
    coarse_sweeps: int = 30

    @classmethod
    def from_system(cls, system, max_levels: int = 10, **kw):
        """Under a ``mesh`` (an X-slab system) the slab form,
        ``solve/slab_mg.py::SlabMultigridPreconditioner``."""
        if getattr(system, "mesh", None) is not None \
                and cls is MultigridPreconditioner:
            from .slab_mg import SlabMultigridPreconditioner

            return SlabMultigridPreconditioner.from_system(
                system, max_levels, **kw)
        levels = [MGLevel(code=system.code, w=system.w,
                          periodic=system.periodic)]
        free = system.free
        w = system.w
        while len(levels) < max_levels and _can_coarsen(tuple(free.shape)):
            free = _coarsen_free(free)
            w = tuple(wi / 4.0 for wi in w)  # dx doubles (aniso preserved)
            levels.append(MGLevel(code=mg_code(free, w, system.periodic),
                                  w=w, periodic=system.periodic))
        return cls(levels=tuple(levels), **kw)

    def _smooth(self, level: MGLevel, x, r, n: int):
        """``n`` damped-Jacobi sweeps ``x + inv_d (r - A x)``, the JAX
        package's loop body, which is K1 sweep's function."""
        for _ in range(n):
            x = level.sweep(x, r, self.omega)
        return x

    def _vcycle(self, idx: int, r):
        level = self.levels[idx]
        x = torch.zeros_like(r)
        if idx == len(self.levels) - 1:
            return self._smooth(level, x, r, self.coarse_sweeps)
        x = self._smooth(level, x, r, self.nu1)
        # full weighting = the block sum of the residual (K1 restrict, one
        # pass) times 1/8, exact in binary
        rc = level.resid_restrict(x, r) * 0.125
        coarse = self.levels[idx + 1]
        rc = torch.where(coarse.free, rc, _zero(r))
        ec = self._vcycle(idx + 1, rc)
        x = x + torch.where(level.free, _prolong(ec), _zero(r))
        return self._smooth(level, x, r, self.nu2)

    def __call__(self, r):
        return self._vcycle(0, r)


def make_multigrid_preconditioner(system, nu1: int = 2, nu2: int = 2,
                                  omega: float = 0.8, coarse_sweeps: int = 30):
    """Return the rediscretised-mask V-cycle preconditioner."""
    return MultigridPreconditioner.from_system(
        system, nu1=nu1, nu2=nu2, omega=omega, coarse_sweeps=coarse_sweeps)
