"""Smoothed-aggregation multigrid (counterpart of
``openimpala_tpu/solve/sa.py``): ``precond="sa"``.

The piecewise-constant coarse space of the Galerkin V-cycle saturates on
labyrinth pore masks.  Here the aggregates stay the geometric 2x2x2 blocks,
but the tentative prolongator P (block injection on the free set) is
smoothed once, ``Ps = (I - om_sa D^-1 A) P``, and the coarse operator is the
true Galerkin product ``Ps^T A Ps``.  Its support is {|o|_inf <= 1} plus the
axial +-2 taps, 33 offsets.  The construction repeats below level 1
(``sa_depth=2``) with the prolongator smoothed by the FILTERED operator
(nearest-neighbour taps only, which bounds the next support at 125
offsets), then plain piecewise-constant Galerkin.

Coarse operators are variable-coefficient offset stencils
(``OffsetLevel``: a tuple of integer offsets and one packed (X, T, Y, Z)
coefficient array; kernel K3 on the card).  They are BUILT BY PROBING: for
a probe vector that is 1 on a sparse lattice (spacing > stencil diameter)
and 0 elsewhere, ``y = R A P x`` reads off one Galerkin matrix column per
lattice cell with no overlap, so ``spacing^3`` matrix-free applications of
the transfer-wrapped operator recover every coefficient exactly.  Each
probe of level 0 is three fine applies (kernel K1).

Fine-level transfers are matrix-free: prolong = S0 (PC-prolong e), one
extra K1 matvec; restrict = blocksum(S0^T r), one more.  The cycle with
symmetric damped-Jacobi smoothing and R = P^T per level is a fixed SPD
operator, so CG stays valid.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.offset import (
    offset_apply,
    offset_resid,
    offset_sweep,
    order_offsets,
)
from ..ops.stencil import _full, _zero
from .preconditioners import MGLevel, _blocksum_axes, _prolong_pc_axes

OM_SA = 2.0 / 3.0  # classic prolongator-smoothing weight ~ 4/(3 lam_max)
_ALL = (0, 1, 2)


def _can_coarsen(shape) -> bool:
    return all(s % 2 == 0 and s >= 8 for s in shape)


# ---------------------------------------------------------------------------
# static offset-support arithmetic (Python ints)
# ---------------------------------------------------------------------------


def _l1_ball(r):
    return tuple(
        (i, j, k)
        for i in range(-r, r + 1)
        for j in range(-r, r + 1)
        for k in range(-r, r + 1)
        if abs(i) + abs(j) + abs(k) <= r
    )


def _minkowski(a, b):
    return tuple(sorted({(p[0] + q[0], p[1] + q[1], p[2] + q[2])
                         for p in a for q in b}))


def _coarsen_support(sup):
    """Coarse offsets reachable by P^T B P for fine support ``sup``:
    fine row 2I+a couples fine col 2I+a+f = 2J+b -> oc = (a+f-b)/2 with
    b = (a+f) mod 2 elementwise."""
    out = set()
    for f in sup:
        for a0 in (0, 1):
            for a1 in (0, 1):
                for a2 in (0, 1):
                    t = (f[0] + a0, f[1] + a1, f[2] + a2)
                    out.add(tuple((ti - (ti % 2)) // 2 for ti in t))
    return tuple(sorted(out))


def _nn_filter(sup):
    """Nearest-neighbour (27-point) subset: the filtered smoother support."""
    return tuple(o for o in sup if max(abs(c) for c in o) <= 1)


def _spacing(sup, shape, periodic):
    """Per-axis probe-lattice spacing: > stencil diameter so every lattice
    cell's Galerkin column is recovered without overlap; on periodic axes
    it must also divide the axis length (the lattice must be consistent
    across the wrap)."""
    sp = []
    for ax in range(3):
        r = max(abs(o[ax]) for o in sup)
        s = 2 * r + 1
        if periodic[ax]:
            while shape[ax] % s != 0:
                s += 1
                if s > shape[ax]:
                    s = shape[ax]
                    break
        sp.append(s)
    return tuple(sp)


# ---------------------------------------------------------------------------
# offset-stencil level
# ---------------------------------------------------------------------------


def _safe_inv(d, num):
    """``d > 0 ? num / d : 0`` elementwise (``num`` a Python float)."""
    return torch.where(d > 0, _full(num, d.dtype, d.device)
                       / torch.where(d > 0, d, 1.0), _zero(d))


@dataclasses.dataclass(frozen=True)
class OffsetLevel:
    """Variable-coefficient stencil  (A x)(i) = sum_o c_o(i) x(i+o).

    Coefficients live PACKED as one (X, T, Y, Z) array in
    ``ops.offset.order_offsets`` order ((0,0,0) at t=0, then the rest of
    the l_inf<=1 ball, ``nn`` taps in all, then wider taps).
    ``apply``/``apply_nn``/``resid``/``sweep`` launch kernel K3 for a CUDA
    tensor and run the roll form (``ops/offset.py``) only for a CPU tensor.
    """

    packed: torch.Tensor
    offsets: tuple
    nn: int = 0

    @classmethod
    def from_coeffs(cls, coeffs, offsets):
        ordered, nn = order_offsets(offsets)
        by_offset = dict(zip(offsets, coeffs))
        packed = torch.stack([by_offset[o] for o in ordered], dim=1)
        return cls(packed=packed, offsets=ordered, nn=nn)

    @property
    def coeffs(self):
        return tuple(self.packed[:, t] for t in range(len(self.offsets)))

    @property
    def diag(self):
        return self.packed[:, self.offsets.index((0, 0, 0))]

    @property
    def free(self):
        return self.diag > 0

    def apply(self, x):
        return offset_apply(x, self.packed, self.offsets)

    def apply_nn(self, x):
        """Apply only the nearest-neighbour taps (the filtered smoother;
        the JAX package's ``apply_sub`` with ``_nn_filter(offsets)``): the
        leading ``nn`` taps, so the kernel reads just the leading block of
        each plane."""
        return offset_apply(x, self.packed, self.offsets, n_taps=self.nn)

    def resid(self, x, r):
        """free-masked residual: where(free, r - A x, 0)."""
        return offset_resid(x, r, self.packed, self.offsets)

    def sweep(self, x, r, omega: float):
        """One damped-Jacobi sweep x + (omega/diag)*(r - A x) on free."""
        return offset_sweep(x, r, self.packed, self.offsets, omega)


# ---------------------------------------------------------------------------
# probing: recover the Galerkin coarse stencil from matrix-free applies
# ---------------------------------------------------------------------------


def _probe(apply_cc, shape_c, sup, spacing, dtype, device, x0: int = 0):
    """The coarse stencil over the symbolic support ``sup``, packed in
    ``order_offsets`` order: ``(packed, ordered_offsets)``.

    For each lattice phase phi, y = A x_phi sums exactly one in-support
    column per cell, so c_o(I) = y_{(I+o) mod s}(I).  The cells that a
    phase settles for tap o are themselves a lattice, (phi - o) mod s, so
    each phase writes one strided slice per tap and every coefficient is
    written exactly once.

    ``x0``: the global X index of the first plane where ``shape_c`` is an
    X slab (``solve/slab_sa.py``): the lattice lives in global X
    coordinates, so plane i of the slab is a lattice plane of phase px
    where ``(x0 + i) % sx == px``."""
    ordered, _ = order_offsets(sup)
    sx, sy, sz = spacing
    packed = torch.zeros((shape_c[0], len(ordered)) + tuple(shape_c[1:]),
                         dtype=dtype, device=device)
    for px in range(sx):
        for py in range(sy):
            for pz in range(sz):
                probe = torch.zeros(shape_c, dtype=dtype, device=device)
                probe[(px - x0) % sx::sx, py::sy, pz::sz] = 1.0
                y = apply_cc(probe)
                for t, o in enumerate(ordered):
                    ix, iy, iz = ((px - o[0] - x0) % sx, (py - o[1]) % sy,
                                  (pz - o[2]) % sz)
                    packed[ix::sx, t, iy::sy, iz::sz] = y[ix::sx, iy::sy,
                                                          iz::sz]
    return packed, ordered


def _prune(packed, ordered, mesh=None) -> OffsetLevel:
    """Drop offsets whose coefficient array is identically zero (the
    symbolic support over-covers the masked geometry); (0,0,0) always
    stays.  One host read of the per-offset max|c|; under a ``mesh`` (the
    rank's slab of the level) the maximum over the ranks, so that every
    rank keeps the same offsets, one card's."""
    mx = packed.abs().amax(dim=(0, 2, 3))
    if mesh is not None:
        mx = mesh.allmax(mx)
    mx = mx.tolist()
    keep = [t for t, o in enumerate(ordered) if mx[t] > 0 or o == (0, 0, 0)]
    if len(keep) < len(ordered):
        packed = packed.index_select(
            1, torch.tensor(keep, device=packed.device))
    offsets, nn = order_offsets(ordered[t] for t in keep)
    return OffsetLevel(packed=packed, offsets=offsets, nn=nn)


def _probe_l0(fine, dinv0, free0, sup, spacing, om, x0: int = 0):
    """Level 0 -> 1: Ps^T A Ps with Ps = (I - om D^-1 A) P around the fused
    fine operator (``x0``: ``_probe``'s)."""
    dtype = dinv0.dtype
    shape_c = tuple(s // 2 for s in dinv0.shape)
    zero = _zero(dinv0)
    om_dinv0 = om * dinv0

    def apply_cc(xc):
        p = _prolong_pc_axes(xc, _ALL)
        p = torch.where(free0, p, zero)
        sp_ = p - om_dinv0 * fine.apply(p)
        q = fine.apply(sp_)
        stq = q - om * fine.apply(dinv0 * q)
        return _blocksum_axes(stq, _ALL)

    return _probe(apply_cc, shape_c, sup, spacing, dtype, dinv0.device, x0)


def _probe_deep(top, sup, spacing, om, smoothed: bool, x0: int = 0):
    """Level k -> k+1 below the fine level: SA with the filtered smoother
    (``top``'s nearest-neighbour taps) when ``smoothed``, else plain
    PC-Galerkin (``x0``: ``_probe``'s)."""
    diag = top.diag
    dtype = diag.dtype
    shape_c = tuple(s // 2 for s in diag.shape)
    free = top.free
    zero = _zero(diag)
    if smoothed:
        dinv = _safe_inv(diag, 1.0)
        om_dinv = om * dinv

        def apply_cc(xc):
            p = _prolong_pc_axes(xc, _ALL)
            p = torch.where(free, p, zero)
            sp_ = p - om_dinv * top.apply_nn(p)
            q = top.apply(sp_)
            stq = q - om * top.apply_nn(dinv * q)
            return _blocksum_axes(stq, _ALL)
    else:

        def apply_cc(xc):
            p = _prolong_pc_axes(xc, _ALL)
            p = torch.where(free, p, zero)
            return _blocksum_axes(top.apply(p), _ALL)

    return _probe(apply_cc, shape_c, sup, spacing, dtype, diag.device, x0)


def _fine_dinv(fine, dtype):
    """(1/diag on the fine free set, 0 elsewhere; free)."""
    diag, free = fine.decode(dtype)
    dinv = torch.where(free & (diag > 0),
                       1.0 / torch.where(diag > 0, diag, 1.0), _zero(diag))
    return dinv, free


def _half(shape) -> tuple:
    return tuple(s // 2 for s in shape)


def _depth(shape, max_levels: int) -> int:
    """How many probed levels ``SAMGPreconditioner.from_system`` builds
    below a fine level of ``shape``: level 1 wherever the volume coarsens,
    then more while it coarsens and ``max_levels`` allows."""
    if not _can_coarsen(shape):
        return 0
    n, shape = 1, _half(shape)
    while n < max_levels - 1 and _can_coarsen(shape):
        n, shape = n + 1, _half(shape)
    return n


# level 1's symbolic support: P^T (S A S) P for the 7-point fine operator
_SUPPORT_1 = _coarsen_support(_minkowski(_minkowski(_l1_ball(1), _l1_ball(1)),
                                         _l1_ball(1)))


def _deep_support(cur_sup, smoothed: bool):
    """The symbolic support of the level below one with offsets
    ``cur_sup``: SA with the FILTERED (27-pt) smoother when ``smoothed``
    (measured identical quality, and it keeps the next support r_inf <=
    2), else plain PC-Galerkin."""
    if smoothed:
        smo_sup = _nn_filter(cur_sup)
        return _coarsen_support(
            _minkowski(_minkowski(smo_sup, cur_sup), smo_sup))
    return _coarsen_support(cur_sup)


def _next_level(top, k: int, shape, periodic, sa_depth: int, om,
                x0: int = 0, mesh=None) -> OffsetLevel:
    """Level k+1 probed below level k >= 1 (``top``, of global ``shape``);
    ``x0`` and ``mesh`` where ``top`` is an X slab (``_probe``,
    ``_prune``)."""
    smoothed = k < sa_depth
    sup = _deep_support(top.offsets, smoothed)
    spacing = _spacing(sup, shape, periodic)
    return _prune(*_probe_deep(top, sup, spacing, om, smoothed, x0), mesh)


def _build_levels(fine, dinv0, free0, shape, periodic, depth: int,
                  sa_depth: int, om) -> list:
    """The ``depth`` probed levels below the fine level (one device)."""
    levels = []
    if depth:
        # --- level 0 -> 1: SA around the fused fine operator -----------
        spacing = _spacing(_SUPPORT_1, shape, periodic)
        levels.append(_prune(*_probe_l0(fine, dinv0, free0, _SUPPORT_1,
                                        spacing, om)))
        shape = _half(shape)
    # --- deeper levels ----------------------------------------------------
    while len(levels) < depth:
        levels.append(_next_level(levels[-1], len(levels), shape, periodic,
                                  sa_depth, om))
        shape = _half(shape)
    return levels


def _cast_levels(levels, coeff_dtype):
    """Downcast AFTER the whole hierarchy is built: probing deeper levels
    through an already-quantised parent would compound the rounding; one
    final cast only quantises the stored operator."""
    if coeff_dtype in ("auto", None):
        return list(levels)
    return [dataclasses.replace(l, packed=l.packed.to(coeff_dtype))
            for l in levels]


# ---------------------------------------------------------------------------
# the preconditioner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SAMGPreconditioner:
    """V-cycle on the smoothed-aggregation hierarchy.

    Level 0 is the packed-geometry fine operator (K1 sweeps, as in the
    Galerkin-PC preconditioner); levels >= 1 are probed OffsetLevels (K3).
    ``sa_depth`` levels of transfers are SA-smoothed (matrix-free S applies
    around the PC transfers); deeper transfers are plain PC.  ``cycle='w'``
    recurses twice per level on levels 1..``w_depth``: the sub-levels hold
    <= 1/8 of the cells, so the W costs little and approximates the
    exact-level-1 solve the two-level analysis assumes.  The coarsest level
    takes ``coarse_sweeps`` damped-Jacobi sweeps.
    """

    fine: MGLevel
    dinv0: torch.Tensor  # 1/diag on the fine free set (0 elsewhere)
    levels: Tuple[OffsetLevel, ...]
    nu1: int = 2
    nu2: int = 2
    omega: float = 0.9
    coarse_sweeps: int = 50
    sa_depth: int = 2
    om_sa: float = OM_SA
    cycle: str = "v"
    w_depth: int = 3

    def __post_init__(self):
        if self.cycle not in ("v", "w"):
            raise ValueError(f"unknown cycle {self.cycle!r}")

    # -- construction ------------------------------------------------------

    @classmethod
    def from_system(cls, system, max_levels: int = 16, sa_depth: int = 2,
                    omega: float = 0.9, coeff_dtype="auto", **kw):
        """``coeff_dtype``: storage dtype of the probed coarse coefficient
        arrays.  "auto" (or None) keeps the system's precision on every
        device, so the CPU and the card apply the same operator;
        ``torch.bfloat16`` halves the coefficient stream (a slightly
        quantised, but fixed, hence still SPD, cycle)."""
        fine = MGLevel(code=system.code, w=system.w,
                       periodic=system.periodic)
        dinv0, free0 = _fine_dinv(fine, system.r0_b.dtype)
        shape = tuple(system.code.shape)
        om = float(kw.pop("om_sa", OM_SA))
        levels = _build_levels(fine, dinv0, free0, shape, system.periodic,
                               _depth(shape, max_levels), sa_depth, om)
        levels = _cast_levels(levels, coeff_dtype)
        return cls(fine=fine, dinv0=dinv0, levels=tuple(levels),
                   sa_depth=int(sa_depth), omega=float(omega), om_sa=om,
                   **kw)

    # -- smoothing ----------------------------------------------------------

    def _fine_smooth(self, x, r, n: int):
        if x is None:
            x = (self.omega * self.dinv0.to(r.dtype)) * r
            n -= 1
        for _ in range(n):
            x = self.fine.sweep(x, r, self.omega)
        return x

    def _lvl_smooth(self, lvl, x, r, n: int):
        """OffsetLevel damped-Jacobi sweeps (K3 sweep on the card);
        ``x=None`` starts from zero with the elementwise first sweep."""
        if x is None:
            x = _safe_inv(lvl.diag.to(r.dtype), self.omega) * r
            n -= 1
        for _ in range(n):
            x = lvl.sweep(x, r, self.omega)
        return x

    # -- SA transfers ------------------------------------------------------

    def _restrict0(self, r):
        dinv = self.dinv0.to(r.dtype)
        str_ = r - self.om_sa * self.fine.apply(dinv * r)
        return _blocksum_axes(str_, _ALL)

    def _prolong0(self, ec, free0, dtype):
        p = _prolong_pc_axes(ec, _ALL)
        p = torch.where(free0, p, _zero(p))
        return p - self.om_sa * self.dinv0.to(dtype) * self.fine.apply(p)

    def _restrict_l(self, idx, r):
        lvl = self.levels[idx - 1]
        if idx < self.sa_depth:
            dinv = _safe_inv(lvl.diag.to(r.dtype), 1.0)
            r = r - self.om_sa * lvl.apply_nn(dinv * r)
        return _blocksum_axes(r, _ALL)

    def _prolong_l(self, idx, ec, dtype):
        lvl = self.levels[idx - 1]
        p = _prolong_pc_axes(ec, _ALL)
        p = torch.where(lvl.free, p, _zero(p))
        if idx < self.sa_depth:
            dinv = _safe_inv(lvl.diag.to(dtype), 1.0)
            p = p - self.om_sa * dinv * lvl.apply_nn(p)
        return p

    # -- the cycle ---------------------------------------------------------

    def _vcycle(self, idx: int, r):
        dtype = r.dtype
        zero = _zero(r)
        if idx == 0:
            if not self.levels:  # volume too small to coarsen at all
                x = torch.zeros_like(r)
                for _ in range(self.coarse_sweeps):
                    x = self.fine.sweep(x, r, self.omega)
                return x
            x = self._fine_smooth(None, r, self.nu1)
            rc = self._restrict0(self.fine.resid(x, r))
            rc = torch.where(self.levels[0].free, rc, zero)
            ec = self._vcycle(1, rc)
            x = x + self._prolong0(ec, self.fine.free, dtype)
            return self._fine_smooth(x, r, self.nu2)

        lvl = self.levels[idx - 1]
        if idx == len(self.levels):
            return self._lvl_smooth(lvl, None, r, self.coarse_sweeps)

        x = self._lvl_smooth(lvl, None, r, self.nu1)
        n_corr = 2 if (self.cycle == "w" and 1 <= idx <= self.w_depth) else 1
        for _ in range(n_corr):
            rc = self._restrict_l(idx, lvl.resid(x, r))
            rc = torch.where(self.levels[idx].free, rc, zero)
            ec = self._vcycle(idx + 1, rc)
            x = x + self._prolong_l(idx, ec, dtype)
        return self._lvl_smooth(lvl, x, r, self.nu2)

    def __call__(self, r):
        return self._vcycle(0, r)
