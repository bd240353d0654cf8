"""Smoothed-aggregation multigrid on X slabs (the decomposed counterpart of
``solve/sa.py::SAMGPreconditioner``, ``precond="sa"``; in the JAX package
GSPMD partitions the same build and cycle, ``tests/test_sa.py::
test_sa_sharded_matches_single_device``).

The hierarchy is built by probing, as on one device, with every decision
taken on the global volume so that every rank holds one card's levels:

* the probe lattice lives in global X coordinates: a rank whose coarse
  slab starts at plane x0 sets ``probe[i] = 1`` where ``(x0 + i) % sx ==
  px`` (``sa.py::_probe``), and reads each coefficient off its own cells;
* the lattice spacing is decided on the global extent (``sa.py::
  _spacing``, with its inherited periodic quirk);
* ``_prune``'s per-offset ``max|c|`` is the maximum over the ranks, so
  every rank keeps the same offsets;
* the fine transfers run K1 on the ghost-padded slab
  (``slab_mg.SlabMGLevel``) and rank-local block sums; each sharded probed
  level is a ``SlabOffsetLevel``: K3 on the slab padded by R exchanged
  planes (``ops/offset.py::slab_offset``, R = the level's X reach, 2 for
  the 33- and 125-tap supports).

Depth: ``follow_depth`` (``solve/slab_mg.py``): a padded X takes the
original extent's depth where the padded extent halves along with it, so
that its levels are the original's with dead planes past its end.

A probed level stays sharded while it is not the coarsest, its slab has
an even number of X planes (its block sums pair planes inside the slab)
and at least R planes (its nearest neighbours fill the halo).  The first
level that fails, ``gather``, is gathered once at build time (its slabs'
coefficients from every rank), every rank builds the levels below it on
the global volume, and the cycle gathers the residual entering it once
per application (``slab_mg.GatheredCycle``).  A fine slab with an odd
number of planes gathers at level 0: every rank then builds and runs the
single-device hierarchy, while the Krylov solve around it stays sharded.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.offset import slab_offset, x_reach
from ..parallel.halo import pad_x
from .sa import (
    OM_SA,
    _SUPPORT_1,
    OffsetLevel,
    SAMGPreconditioner,
    _build_levels,
    _cast_levels,
    _depth,
    _fine_dinv,
    _half,
    _next_level,
    _probe_l0,
    _prune,
    _spacing,
)
from .preconditioners import MGLevel
from .slab_mg import GatheredCycle, SlabMGLevel, _GatheredLevel, follow_depth


def stays_sharded(k: int, depth: int, xl: int, reach: int) -> bool:
    """Whether probed level ``k`` of a hierarchy of ``depth`` levels stays
    on the slabs: not the coarsest, an even slab of ``xl`` planes, and at
    least ``reach`` (R, its X reach) planes, so that its block sums pair
    planes inside the slab and its nearest neighbours fill its halo."""
    return k < depth and xl % 2 == 0 and xl >= max(1, reach)


@dataclasses.dataclass(frozen=True)
class SlabOffsetLevel:
    """A probed level on this rank's slab: the coefficients in K3's slab
    layout (``padded``, ``(X_local + 2 width, T, Y, Z)``, the ghost planes
    0), and the ``OffsetLevel`` interface, each mode K3 on the padded slab
    (``slab_offset``)."""

    padded: torch.Tensor
    offsets: tuple
    nn: int
    width: int
    periodic_x: bool
    mesh: object

    @classmethod
    def from_slab(cls, lvl: OffsetLevel, periodic_x: bool, mesh):
        width = max(1, x_reach(lvl.offsets))
        return cls(padded=pad_x(lvl.packed, width), offsets=lvl.offsets,
                   nn=lvl.nn, width=width, periodic_x=bool(periodic_x),
                   mesh=mesh)

    @property
    def packed(self):
        """The slab's (X_local, T, Y, Z) coefficients (a view)."""
        return self.padded[self.width:-self.width]

    @property
    def diag(self):
        return self.packed[:, self.offsets.index((0, 0, 0))]

    @property
    def free(self):
        return self.diag > 0

    def _k3(self, mode, x, r=None, n_taps=None, omega: float = 0.9):
        return slab_offset(mode, x, r, self.padded, self.offsets, self.width,
                           self.periodic_x, self.mesh, n_taps=n_taps,
                           omega=omega)

    def apply(self, x):
        return self._k3("apply", x)

    def apply_nn(self, x):
        return self._k3("apply", x, n_taps=self.nn)

    def resid(self, x, r):
        return self._k3("resid", x, r)

    def sweep(self, x, r, omega: float):
        return self._k3("sweep", x, r, omega=omega)


@dataclasses.dataclass(frozen=True)
class SlabSAMGPreconditioner(GatheredCycle, SAMGPreconditioner):
    """``SAMGPreconditioner`` on X slabs (module docstring): ``fine`` and
    ``dinv0`` are this rank's slab, ``levels`` the sharded
    ``SlabOffsetLevel``s above ``gather``, then the slab of the gathered
    level's free set; from ``gather`` on, ``glob`` (the single-device
    class on the global levels) runs the cycle on every rank."""

    mesh: object = None
    glob: SAMGPreconditioner = None
    gather: int = 0

    @classmethod
    def from_system(cls, system, max_levels: int = 16, sa_depth: int = 2,
                    omega: float = 0.9, coeff_dtype="auto", **kw):
        mesh, periodic = system.mesh, system.periodic
        xl = int(system.code.shape[0])
        shape = (xl * mesh.size,) + tuple(system.code.shape[1:])
        depth = follow_depth(system, lambda s: _depth(s, max_levels))
        om = float(kw.pop("om_sa", OM_SA))
        opts = dict(sa_depth=int(sa_depth), omega=float(omega), om_sa=om,
                    **kw)
        fine = SlabMGLevel(code=system.code, code_halo=system.code_halo,
                           w=system.w, periodic=periodic, mesh=mesh)
        dtype = system.r0_b.dtype
        dinv0, free0 = _fine_dinv(fine, dtype)
        if depth == 0 or xl % 2:
            # gathered at the fine level: the single-device hierarchy
            gfine = MGLevel(code=mesh.all_gather_x(system.code), w=system.w,
                            periodic=periodic)
            gdinv0, gfree0 = _fine_dinv(gfine, dtype)
            glevels = _build_levels(gfine, gdinv0, gfree0, shape, periodic,
                                    depth, sa_depth, om)
            glob = SAMGPreconditioner(
                fine=gfine, dinv0=gdinv0,
                levels=tuple(_cast_levels(glevels, coeff_dtype)), **opts)
            return cls(fine=fine, dinv0=dinv0, levels=(), mesh=mesh,
                       glob=glob, gather=0, **opts)

        # level 1 probed around K1 on the slabs
        spacing = _spacing(_SUPPORT_1, shape, periodic)
        lvl = _prune(*_probe_l0(fine, dinv0, free0, _SUPPORT_1, spacing, om,
                                x0=mesh.rank * (xl // 2)), mesh)
        shape, xl, k = _half(shape), xl // 2, 1
        sharded = []
        while stays_sharded(k, depth, xl, x_reach(lvl.offsets)):
            top = SlabOffsetLevel.from_slab(lvl, periodic[0], mesh)
            sharded.append(top)
            lvl = _next_level(top, k, shape, periodic, sa_depth, om,
                              x0=mesh.rank * (xl // 2), mesh=mesh)
            shape, xl, k = _half(shape), xl // 2, k + 1
        g = k
        # level g gathered from the slabs; the levels below it built on
        # the global volume by every rank
        glevels = [OffsetLevel(packed=mesh.all_gather_x(lvl.packed),
                               offsets=lvl.offsets, nn=lvl.nn)]
        while g + len(glevels) - 1 < depth:
            glevels.append(_next_level(glevels[-1], g + len(glevels) - 1,
                                       shape, periodic, sa_depth, om))
            shape = _half(shape)
        glevels = _cast_levels(glevels, coeff_dtype)
        if coeff_dtype not in ("auto", None):
            sharded = [dataclasses.replace(s, padded=s.padded.to(coeff_dtype))
                       for s in sharded]
        glob = SAMGPreconditioner(fine=None, dinv0=None,
                                  levels=(None,) * (g - 1) + tuple(glevels),
                                  **opts)
        gathered = _GatheredLevel(
            free=glevels[0].free[mesh.rank * xl:(mesh.rank + 1) * xl])
        return cls(fine=fine, dinv0=dinv0,
                   levels=tuple(sharded) + (gathered,)
                   + (None,) * (depth - g),
                   mesh=mesh, glob=glob, gather=g, **opts)
