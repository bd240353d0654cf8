"""The default Galerkin multigrid cycle and the rediscretised ``"mg"``
cycle on X slabs (the decomposed counterparts of ``preconditioners.
GalerkinMGPreconditioner`` and ``MultigridPreconditioner``; in the JAX
package GSPMD partitions the same cycles, ``tests/test_parallel.py::
test_sharded_galerkin_mg_matches_single_device``).  The rules below are
the default cycle's; ``SlabMultigridPreconditioner`` keeps the gather
rule and takes its depth from ``follow_depth``.

The hierarchy's schedule is the single-device one, decided on the global
shape as the user gave it: where the mesh pads X with inactive planes
(``StencilSystem.x_extent``), on the original extent, so that the levels
are the original's with dead planes past its end and the cycle, and the
iterations, are those of the volume on one device.  Where the padded
extent cannot follow that schedule (an X coarsening meets an odd padded
extent), the padded shape's own schedule is taken.

A level stays sharded as long as each coarsening pairs X planes inside a
slab: the transfer from level k to k+1 is rank-local where X does not
coarsen there or the slab's X extent at level k is even.
From the first level where that fails the cycle is gathered: the residual
entering that level is gathered from every rank (one ``all_gather`` per
cycle), every rank runs the rest of the cycle on the global levels (the
single-device code, so the same arithmetic), and each keeps its slab of
the correction.  A slab whose X extent is odd (36 over 4 ranks: 9) is
gathered at the fine level: the whole cycle runs replicated, while the
PCG around it stays sharded.

Where every coarsening is rank-local, the coarsest level's Chebyshev
solve (some hundred steps) runs on the slabs when that level has at
least ``SLAB_COARSE_MIN_CELLS`` cells globally: K2's cheby step on each
rank's slab padded by one plane, one exchange of the two ghost planes a
step (``SlabConductanceLevel.cheby_step``; the interval is fixed on the
host and the iteration takes no dot product, so each cell computes what
it computes on the global level).  On ``nccl`` ranks the solve is one
CUDA graph per hierarchy (``_coarse_graphed``), so its steps run at the
card's pace, not at the host's.  Below that size, with the Jacobi
coarse solve, and for ``SlabMultigridPreconditioner`` the coarsest level
is gathered as above, where its solve costs no exchange at all.

The sharded levels run the kernels on ghost-padded slabs: the fine level
K1 (``ops/stencil.py``'s slab layout), the coarse levels K2 on slabs
padded by one plane, whose ghost planes carry the neighbour's values and
the conductances across the seams.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import torch

from ..ops import stencil_cuda
from ..ops.stencil import (
    StencilSystem,
    _on_cpu,
    code_slab,
    decode_code,
    slab_stencil,
)
from ..parallel.halo import halo_exchange_x, pad_x
from ..parallel.mesh import stats as mesh_stats
from ..utils import graphs
from .preconditioners import (
    ConductanceLevel,
    GalerkinMGPreconditioner,
    MGLevel,
    MultigridPreconditioner,
    _coarsen_free,
    fine_conductances,
    galerkin_coarsen,
    mg_code,
    mg_depth,
)

# The global cell count from which the default cycle's coarsest level is
# solved on the slabs rather than gathered (module docstring).  One
# coarse solve on four H100s (nccl, the slab solve graphed), gathered
# against on the slabs (scripts/slab_coarse_crossover.py; PERF.md): 1.62
# against 0.39 ms at coarsest 32^3, 2.13 / 0.73 at 64^3, 6.69 / 1.88 at
# 128^3, 49.0 / 17.0 at 256^3; the smallest level measured sets it.
SLAB_COARSE_MIN_CELLS = 32 ** 3


@dataclasses.dataclass(frozen=True)
class SlabMGLevel:
    """The fine level on a slab: the packed code (``code``, the slab's;
    ``code_halo``, K1's slab layout) and K1 through ``slab_stencil``
    (each call copies its operands into the slab layout with the
    neighbours' planes as ghosts), for the base class's cycle."""

    code: torch.Tensor
    code_halo: torch.Tensor
    w: tuple
    periodic: tuple
    mesh: object

    def decode(self, dtype):
        return decode_code(self.code, self.w, dtype)

    @property
    def free(self):
        return self.code > 0

    def _k1(self, mode, x, r=None, omega: float = 0.9):
        return slab_stencil(mode, x, r, self.code_halo, self.w,
                            self.periodic, self.mesh, omega=omega)

    def apply(self, x):
        return self._k1("matvec", x)

    def sweep(self, x, r, omega: float):
        return self._k1("sweep", x, r, omega)

    def resid(self, x, r):
        return self._k1("resid", x, r)

    def resid_restrict(self, x, r):
        return self._k1("restrict", x, r)


@dataclasses.dataclass(frozen=True)
class SlabConductanceLevel:
    """A Galerkin coarse level on a slab: ``diag`` (the slab's, for the
    cycle's elementwise work) and ``padded``, the level on the slab padded
    by one X plane on each side, where the lower plane's X conductance is
    the one across the seam from the previous rank and everything else on
    the two planes is 0.  ``apply``/``sweep`` copy ``x`` into that layout
    with the neighbours' planes as ghosts and run K2 on it (the roll form
    on the CPU), which is the global operator's rows of this slab.
    ``cheby_init``/``cheby_step`` run the Chebyshev iteration from zero on
    padded buffers kept for the whole solve; ``coarsest``: the cycle's
    coarsest level, whose exchanges count as ``coarse_slab_exchanges``."""

    diag: torch.Tensor
    padded: ConductanceLevel
    mesh: object
    coarsest: bool = False
    # the running Chebyshev solve (``_PaddedSolve``), set by cheby_init
    _solve: list = dataclasses.field(default_factory=list, repr=False,
                                     compare=False)

    @classmethod
    def from_slab(cls, lvl: ConductanceLevel, mesh, coarsest: bool = False):
        seam = halo_exchange_x(lvl.cx, True, mesh)[:1]  # previous rank's
        return cls(diag=lvl.diag, mesh=mesh, coarsest=coarsest,
                   padded=ConductanceLevel(
                       diag=pad_x(lvl.diag), cx=pad_x(lvl.cx, lo=seam),
                       cy=pad_x(lvl.cy), cz=pad_x(lvl.cz)))

    @property
    def free(self):
        return self.diag > 0

    def apply(self, x):
        # the X roll of the conductance operator wraps: a periodic
        # exchange, whose wrap the zero conductance of a clamped X cancels
        xp = halo_exchange_x(x, True, self.mesh)
        return self.padded.apply(xp)[1:-1]

    def sweep(self, x, r, omega: float):
        xp = halo_exchange_x(x, True, self.mesh)
        return self.padded.sweep(xp, pad_x(r), omega)[1:-1]

    def cheby_init(self, r, c0: float):
        """The zero-start step (``ConductanceLevel.cheby_init``) on ``r``
        padded by one X plane: ``(res, d, x)``, ``res`` and ``d`` padded,
        ``x`` the interior of the padded solution.  The padded planes have
        ``diag`` 0, so ``inv_d`` 0: their ``res`` and ``x`` are never
        read, and ``d``'s are rewritten before every step.  The spare
        buffer the steps alternate with ``d`` is made here, and for each
        of the two as ``d`` the ghost exchange and, on the card, K2's step
        are prepared once."""
        res, d, xp = self.padded.cheby_init(pad_x(r), c0)
        spare = torch.empty_like(d)
        count = "coarse_slab_exchanges" if self.coarsest else None
        p = self.padded
        steps = []
        for buf, other in ((d, spare), (spare, d)):
            launch = None if _on_cpu(buf) else stencil_cuda.k2_cheby_bound(
                False, buf, res, xp, p.cx, p.cy, p.cz, p.diag, other)
            steps.append((buf, other, launch,
                          self.mesh.ghost_exchange(buf, True, count)))
        self._solve[:] = [_PaddedSolve(res=res, x=xp, steps=tuple(steps))]
        return res, d, xp[1:-1]

    def cheby_step(self, res, d, x, c1: float, c2: float, out=None):
        """One later step on ``cheby_init``'s buffers: ``d``'s ghost planes
        from the neighbours (periodic, as ``apply``'s), then K2's cheby
        step on the padded slab, which updates ``res`` and the padded
        solution (``x`` is its interior) in place and writes ``d'`` into
        the other buffer (``out``: None at the first step).  On the CPU
        the roll form, written back into the same buffers."""
        res, d_new = self._solve[0].step(self.padded, d, out, c1, c2)
        return res, d_new, x


@dataclasses.dataclass(frozen=True)
class _PaddedSolve:
    """One Chebyshev solve on a slab level: ``res``, the padded solution
    ``x``, and for each of the two buffers that take turns as ``d``:
    ``(d, the other, K2's bound step or None on the CPU, its exchange)``."""

    res: torch.Tensor
    x: torch.Tensor
    steps: tuple

    def step(self, padded: ConductanceLevel, d, out, c1: float, c2: float):
        """``(res, d')`` after one step from ``d``."""
        for buf, other, launch, fill in self.steps:
            if buf is d and (out is None or out is other):
                break
        else:
            raise ValueError("d and out are not buffers of this solve")
        fill()
        if launch is not None:
            launch(c1, c2)
        else:
            for t, new in zip((self.res, other, self.x),
                              padded.cheby_step_plain(self.res, d, self.x,
                                                      c1, c2)):
                t.copy_(new)
        return self.res, other


@dataclasses.dataclass(frozen=True)
class _GatheredLevel:
    """The slab of a gathered level's free set (what the cycle above it
    masks its restricted residual with)."""

    free: torch.Tensor


def _slab_of(t, mesh, xloc: int):
    return t[mesh.rank * xloc:(mesh.rank + 1) * xloc]


class GatheredCycle:
    """The slab cycles' hand-off (a mixin before the single-device class):
    at level ``gather`` the residual is gathered from every rank, every
    rank runs the rest of the cycle on the global levels (``glob``, the
    single-device class, so the same arithmetic) and keeps its slab of
    the correction."""

    def _vcycle(self, idx: int, r):
        if idx == self.gather:
            e = self.glob._vcycle(idx, self.mesh.all_gather_x(r))
            return _slab_of(e, self.mesh, r.shape[0])
        return super()._vcycle(idx, r)


def follow_depth(system, depth_of) -> int:
    """The depth of a hierarchy that halves every axis at every level
    (``depth_of(shape)``, SA's and ``mg``'s rule) on the slab system's
    global shape: the original extent's where the mesh pads X and the
    padded extent halves wherever the original does (its padded planes
    are then dead cells of every level), else the padded shape's own."""
    xloc, Y, Z = (int(v) for v in system.code.shape)
    X = xloc * system.mesh.size
    depth = depth_of((system.x_extent or X, Y, Z))
    for _ in range(depth):
        if X % 2:
            return depth_of((xloc * system.mesh.size, Y, Z))
        X //= 2
    return depth


def _x_pairs(schedule, X: int) -> bool:
    """Whether an X extent of ``X`` planes halves at every step of
    ``schedule`` that coarsens X."""
    for axes in schedule:
        if 0 in axes:
            if X % 2:
                return False
            X //= 2
    return True


def gather_level(x_local: int, schedule, transfer: str = "pc") -> int:
    """The first level whose coarsening is not rank-local (a slab of
    ``x_local`` planes at the fine level), or the coarsest level: where
    the cycle is gathered (the coarsest only where ``coarse_on_slabs``
    says no)."""
    if transfer != "pc":
        return 0  # trilinear transfers read across every seam
    for k, axes in enumerate(schedule):
        if 0 in axes:
            if x_local % 2:
                return k
            x_local //= 2
    return len(schedule)


def coarse_on_slabs(gather: int, schedule, coarsest_cells: int,
                    coarse_solver: str = "cheby") -> bool:
    """Whether the default cycle solves its coarsest level on the slabs
    (module docstring): every coarsening is rank-local (``gather``, of
    ``gather_level``, is the coarsest level), the coarse solve is the
    Chebyshev one, and the global coarsest level has at least
    ``SLAB_COARSE_MIN_CELLS`` cells."""
    return (len(schedule) > 0 and gather == len(schedule)
            and coarse_solver == "cheby"
            and coarsest_cells >= SLAB_COARSE_MIN_CELLS)


@dataclasses.dataclass(frozen=True)
class SlabGalerkinMGPreconditioner(GatheredCycle, GalerkinMGPreconditioner):
    """``GalerkinMGPreconditioner`` on X slabs (module docstring): levels
    below ``gather`` are this rank's slabs, levels from ``gather`` on are
    global and run by ``glob``, a ``GalerkinMGPreconditioner`` of the same
    options, on every rank.  ``gather`` None: every level, the coarsest
    included, is this rank's slab (``coarse_on_slabs``), and there is no
    ``glob``."""

    mesh: object = None
    glob: GalerkinMGPreconditioner = None
    gather: int | None = 0
    # the coarsest solve's CUDA graphs by (dtype, shape): (graph, static
    # residual, solution, launch counts, mesh stats)
    _graphs: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def _vcycle(self, idx: int, r):
        if (self.gather is None and idx == len(self.levels) and r.is_cuda
                and self.mesh.backend == "nccl" and not graphs.eager_only()):
            return self._coarse_graphed(idx, r)
        return super()._vcycle(idx, r)

    def _coarse_graphed(self, idx: int, r):
        """The coarsest solve on the slabs as one CUDA graph per dtype and
        shape of the hierarchy, its ghost exchanges (``nccl``'s P2P)
        included: eager at the first call (NCCL's connections made, the
        kernels loaded), captured behind it, replayed from then on.  Eager,
        the host's exchanges and launches would set its pace (PERF.md's
        crossover).  Each replay adds the capture's launch counts
        and exchanges to the counters."""
        key = (r.dtype, tuple(r.shape))
        held = self._graphs.get(key)
        if held is None:
            solve = functools.partial(super()._vcycle, idx)
            out = solve(r)
            static_r = r.clone()
            before = collections.Counter(mesh_stats)
            graph, x, deltas = graphs.capture(solve, static_r)
            exchanges = mesh_stats - before  # a capture exchanges nothing
            mesh_stats.clear()
            mesh_stats.update(before)
            self._graphs[key] = (graph, static_r, x, deltas, exchanges)
            return out
        graph, static_r, x, deltas, exchanges = held
        static_r.copy_(r)
        graph.replay()
        stencil_cuda.add_counts(deltas)
        mesh_stats.update(exchanges)
        return x

    @classmethod
    def from_system(cls, system, max_levels: int = 3, **kw):
        mesh = system.mesh
        xloc, Y, Z = (int(v) for v in system.code.shape)
        gshape = (xloc * mesh.size, Y, Z)
        live = (system.x_extent or gshape[0], Y, Z)
        schedule = kw.pop("schedule", None)
        if schedule is None:
            schedule = cls._schedule_for(live, system.w, max_levels)
            if not _x_pairs(schedule, gshape[0]):
                live = gshape
                schedule = cls._schedule_for(gshape, system.w, max_levels)
        schedule = tuple(tuple(a) for a in schedule)
        coarsest = list(live)
        for axes in schedule:
            for a in axes:
                coarsest[a] //= 2
        # the coarse solve is scaled to the live coarsest level
        cls._coarse_defaults(kw, coarsest)
        g = gather_level(xloc, schedule, kw.get("transfer", "pc"))
        fine = SlabMGLevel(code=system.code, code_halo=system.code_halo,
                           w=system.w, periodic=system.periodic, mesh=mesh)
        if g == 0:
            gsys = StencilSystem(
                code=mesh.all_gather_x(system.code),
                x_forced=system.r0_b.new_zeros(()),
                r0_b=system.r0_b.new_zeros(()),
                b_norm=system.b_norm, w=system.w, periodic=system.periodic)
            glob = GalerkinMGPreconditioner.from_system(
                gsys, max_levels, schedule=schedule, **kw)
            opts = {f.name: getattr(glob, f.name) for f in dataclasses.fields(
                GalerkinMGPreconditioner) if f.name not in ("fine", "levels")}
            return cls(fine=fine, levels=(), mesh=mesh, glob=glob, gather=0,
                       **opts)
        gcoarse = list(gshape)
        for axes in schedule:
            for a in axes:
                gcoarse[a] //= 2
        on_slabs = coarse_on_slabs(g, schedule, math.prod(gcoarse),
                                   kw.get("coarse_solver", "cheby"))
        kw["schedule"] = schedule
        # sharded levels 1 .. g (level g only to be gathered unless the
        # coarsest stays on the slabs), then global
        cur, sharded, xl = fine_conductances(system, mesh), [], xloc
        glevels = []
        for k, axes in enumerate(schedule, start=1):
            if k <= g:
                cur = galerkin_coarsen(cur, axes, mesh)
                xl = xl // 2 if 0 in axes else xl
                if k < g or on_slabs:
                    sharded.append(SlabConductanceLevel.from_slab(
                        cur, mesh, coarsest=k == len(schedule)))
                    continue
                cur = ConductanceLevel(*(mesh.all_gather_x(t) for t in (
                    cur.diag, cur.cx, cur.cy, cur.cz)))
            else:
                cur = galerkin_coarsen(cur, axes)
            glevels.append(cur)
        if on_slabs:
            return cls(fine=fine, levels=tuple(sharded), mesh=mesh,
                       gather=None, **kw)
        glob = GalerkinMGPreconditioner(
            fine=None, levels=(None,) * (g - 1) + tuple(glevels), **kw)
        # level g's slab masks the residual the last sharded level
        # restricts; deeper levels live in ``glob`` only
        gathered = (_GatheredLevel(free=_slab_of(glevels[0].free, mesh, xl)),)
        return cls(fine=fine, levels=tuple(sharded) + gathered
                   + (None,) * (len(glevels) - 1),
                   mesh=mesh, glob=glob, gather=g, **kw)


@dataclasses.dataclass(frozen=True)
class SlabMultigridPreconditioner(GatheredCycle, MultigridPreconditioner):
    """``MultigridPreconditioner`` (``precond="mg"``) on X slabs: every
    sharded level is a ``SlabMGLevel`` with its own ``code_halo``, so K1
    runs on each of them; a coarse level's free set is coarsened on the
    rank (X pairs inside the slab) and its code rediscretised on the slab
    (``pack_code_for`` with the mesh: one exchange of the free planes
    across the seams).  Levels stay sharded while X pairs inside a slab;
    from the first level whose coarsening is not rank-local, and in any
    case at the coarsest, the cycle is gathered (``GatheredCycle``; the
    rule of the module docstring).  The depth follows ``follow_depth``:
    a padded X takes the original extent's depth where it can."""

    mesh: object = None
    glob: MultigridPreconditioner = None
    gather: int = 0

    @classmethod
    def from_system(cls, system, max_levels: int = 10, **kw):
        mesh, periodic = system.mesh, system.periodic
        xloc = int(system.code.shape[0])
        depth = follow_depth(system, lambda s: mg_depth(s, max_levels))
        g = gather_level(xloc, ((0, 1, 2),) * depth)
        free, w = system.free, system.w
        levels = [SlabMGLevel(code=system.code, code_halo=system.code_halo,
                              w=w, periodic=periodic, mesh=mesh)]
        for _ in range(1, g):
            free, w = _coarsen_free(free), tuple(wi / 4.0 for wi in w)
            code = mg_code(free, w, periodic, mesh)
            levels.append(SlabMGLevel(code=code, code_halo=code_slab(code),
                                      w=w, periodic=periodic, mesh=mesh))
        if g == 0:
            glevels = [MGLevel(code=mesh.all_gather_x(system.code), w=w,
                               periodic=periodic)]
            gfree = glevels[0].free
        else:
            free, w = _coarsen_free(free), tuple(wi / 4.0 for wi in w)
            gfree = mesh.all_gather_x(free)
            glevels = [MGLevel(code=mg_code(gfree, w, periodic), w=w,
                               periodic=periodic)]
        while g + len(glevels) - 1 < depth:  # levels g .. depth, global
            gfree, w = _coarsen_free(gfree), tuple(wi / 4.0 for wi in w)
            glevels.append(MGLevel(code=mg_code(gfree, w, periodic), w=w,
                                   periodic=periodic))
        glob = MultigridPreconditioner(levels=(None,) * g + tuple(glevels),
                                       **kw)
        if g:  # level g's slab masks the residual level g - 1 restricts
            levels += [_GatheredLevel(free=free)] + [None] * (depth - g)
        return cls(levels=tuple(levels), mesh=mesh, glob=glob, gather=g,
                   **kw)
