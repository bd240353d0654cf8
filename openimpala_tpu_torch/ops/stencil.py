"""Masked 7-point stencil systems, matrix-free (the counterpart of
``openimpala_tpu/ops/stencil.py``).

**Flow-through (tortuosity) operator** — reference
``src/props/TortuosityHypreFill.F90:44-262``: inactive cells are identity
rows; active cells carry ``a_c = sum_f w_f m_f`` and ``-w_f`` to each active
neighbour (``w_f = 1/dx_f^2``); active cells on the inlet/outlet plane are
Dirichlet rows with rhs vlo/vhi.

**Periodic cell problem operator** — reference
``src/props/EffDiffFillMtx.F90:42-264``: the diagonal sums all 6 faces,
off-diagonals go to active neighbours, every axis wraps.

Both are solved in eliminated (free-set) form, where the operator is SPD.

Packed geometry: one bf16 value per cell carries the operator.  Isotropic
spacing packs ``free ? n_active_neighbours : -1``; anisotropic spacing packs
the per-axis counts ``free ? cx*16 + cy*4 + cz : -1``.  ``decode_code``
recovers (diag, free) exactly; the CUDA kernel K1 decodes in-register.

Dispatch rule: ``apply_code``, ``apply_code_with_dot``, ``smooth_sweep``,
``residual_restricted`` and ``residual_restrict`` launch the CUDA kernel K1
(``ops/stencil_cuda.py``) for a CUDA tensor, and run the plain PyTorch form
beside them only for a CPU tensor.  Any other device raises.
``apply_restricted`` and ``apply_restricted_with_dot``, the operator from
explicit (diag, free) arrays and optionally over a batch of volumes, go to
K4 or K5 by the same rule (``restricted_kernel`` says which);
``apply_restricted_slab`` is the unbatched operator on an X slab, K5 on
the slab padded by one exchanged plane.

X slabs (``parallel/mesh.py``): a system built with a ``mesh`` holds this
rank's slab of every field, and its code once more in the slab layout of
K1 (``code_slab``): two planes of -1 ("not free") on each side of the
slab.  A stencil on a slab (``slab_stencil``) copies its input into that
layout, fills the inner plane of each side from the neighbouring rank
(the ghost plane; the outer one stays 0 and is read by no free cell), and
runs K1 on the whole padded slab with X clamped: the ghosts carry the
neighbours' values (on a periodic X, the cell problems', rank 0's lower
ghost is the last rank's last plane: the wrap crosses the seam there, and
K1 itself never wraps X), K1 writes 0 on the ghost planes and adds
nothing for them to the fused dot, and ``restrict`` pairs the planes (2k, 2k+1) of
the padded slab, which are the slab's own pairs whenever the slab's X is
even; its coarse output comes padded by one plane of 0 on each side.
"""

from __future__ import annotations

import dataclasses

import torch

from ..parallel.halo import (
    fill_ghosts_,
    halo_exchange_x,
    pad_halo,
    pad_halo_slab,
)
from . import stencil_cuda

Axis = int  # 0=X, 1=Y, 2=Z (matches reference Direction enum)


def neighbor_sum(x, w, periodic):
    """sum_f w_f * x(neighbour_f) for the 6 face neighbours (zero outside
    clamped axes, wrapped on periodic axes).  ``x`` is (X, Y, Z) or a
    batch (B, X, Y, Z): every lane wraps on its own."""
    xp = pad_halo(x, periodic)
    return (
        w[0] * (xp[..., :-2, 1:-1, 1:-1] + xp[..., 2:, 1:-1, 1:-1])
        + w[1] * (xp[..., 1:-1, :-2, 1:-1] + xp[..., 1:-1, 2:, 1:-1])
        + w[2] * (xp[..., 1:-1, 1:-1, :-2] + xp[..., 1:-1, 1:-1, 2:])
    )


def weighted_degree(active, w, periodic, dtype):
    """Diagonal of the tortuosity operator: sum_f w_f * active(neighbour_f)
    (``TortuosityHypreFill.F90:126-166``)."""
    return neighbor_sum(active.to(dtype), w, periodic)


def neighbor_count_axes(active, periodic, mesh=None):
    """Per-axis active-neighbour counts ((cx, cy, cz), each 0..2, int8);
    under a ``mesh``, of this rank's slab, the X neighbours across a seam
    from the neighbouring rank's plane."""
    a8 = active.to(torch.int8)
    ap = pad_halo(a8, periodic) if mesh is None else pad_halo_slab(
        a8, periodic, mesh)
    sl = [slice(1, -1)] * 3
    counts = []
    for ax in range(3):
        lo, hi = list(sl), list(sl)
        lo[ax] = slice(0, -2)
        hi[ax] = slice(2, None)
        counts.append(ap[tuple(lo)] + ap[tuple(hi)])
    return tuple(counts)


def neighbor_count(active, periodic, mesh=None):
    """Total active-neighbour count (0..6) per cell, int8; under a
    ``mesh``, of this rank's slab."""
    cx, cy, cz = neighbor_count_axes(active, periodic, mesh)
    return cx + cy + cz


def _minus_one_bf16(device):
    return torch.full((), -1.0, dtype=torch.bfloat16, device=device)


def pack_code(nsum, free):
    """Isotropic signed-count packing: free ? nsum : -1."""
    return torch.where(free, nsum.to(torch.bfloat16),
                       _minus_one_bf16(nsum.device))


def pack_code_axes(counts, free):
    """Anisotropic per-axis packing: free ? cx*16 + cy*4 + cz : -1."""
    cx, cy, cz = (c.to(torch.int32) for c in counts)
    return torch.where(free, (cx * 16 + cy * 4 + cz).to(torch.bfloat16),
                       _minus_one_bf16(cx.device))


def pack_code_for(w, active, free, periodic, mesh=None):
    """The packed geometry for weights ``w`` (mirrors ``decode_code``);
    under a ``mesh``, of this rank's slab, the X neighbours across a seam
    read from the neighbouring rank's plane (one exchange)."""
    counts = neighbor_count_axes(active, periodic, mesh)
    if uniform_w(w):
        return pack_code(counts[0] + counts[1] + counts[2], free)
    return pack_code_axes(counts, free)


def unpack_code_axes(code, dtype):
    """(cx, cy, cz) per-axis counts from the anisotropic packing, in
    ``dtype``.  Exact: 1/16 and 1/4 are powers of two and the packed values
    are small integers."""
    c = code.clamp(min=0).to(dtype)
    cx = torch.floor(c * 0.0625)
    rem = c - cx * 16
    cy = torch.floor(rem * 0.25)
    cz = rem - cy * 4
    return cx, cy, cz


def decode_code(code, w, dtype):
    """(diag, free) from the packed geometry, dispatching on the weight
    tuple: isotropic count decode or per-axis unpack."""
    free = code > 0
    if uniform_w(w):
        return code.clamp(min=0).to(dtype) * w[0], free
    cx, cy, cz = unpack_code_axes(code, dtype)
    # same expression and evaluation order as weighted_degree
    return w[0] * cx + w[1] * cy + w[2] * cz, free


def uniform_w(w) -> bool:
    return w[0] == w[1] == w[2]


def _zero(x):
    """0-d zero of ``x``'s dtype and device."""
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _full(v, dtype, device):
    """0-d tensor (a fill kernel on the card, never a host-to-device
    copy)."""
    return torch.full((), v, dtype=dtype, device=device)


def _on_cpu(x) -> bool:
    """The dispatch rule: CPU tensors take the plain form, everything else
    goes to the kernel wrapper (which raises unless it is CUDA)."""
    return x.device.type == "cpu"


# ---------------------------------------------------------------------------
# Plain PyTorch forms of kernels K1, K4 and K5.  The dispatchers below call
# them only for CPU tensors; on the card they serve as the reference the
# kernel is held against, and every call with a CUDA tensor is counted
# (``stencil_cuda.plain_on_cuda``) so a run can show the solve never took
# them there.
# ---------------------------------------------------------------------------


def apply_restricted_plain(x, diag, free, w, periodic):
    """Action of the free-set operator with explicit (diag, free):
    ``free ? diag*x - sum_f w_f x_nbr : 0``.  The one plain form of K1's
    matvec and of K4 and K5.  ``x`` is (X, Y, Z) or (B, X, Y, Z); ``diag``
    broadcasts against it, or is (B,), one scalar per lane."""
    stencil_cuda.note_plain("k1_matvec", x)
    if diag.dim() == 1 and x.dim() == 4:
        diag = diag[:, None, None, None]
    if free.dtype != torch.bool:  # an int8 mask, as the kernels take it
        free = free != 0
    return torch.where(free, diag * x - neighbor_sum(x, w, periodic),
                       _zero(x))


def apply_restricted_with_dot_plain(x, diag, free, w, periodic):
    ax = apply_restricted_plain(x, diag, free, w, periodic)
    return ax, torch.sum(x * ax, dim=(-3, -2, -1))


def apply_code_plain(x, code, w, periodic):
    diag, free = decode_code(code, w, x.dtype)
    return apply_restricted_plain(x, diag, free, w, periodic)


def apply_code_with_dot_plain(x, code, w, periodic):
    ax = apply_code_plain(x, code, w, periodic)
    return ax, torch.sum(x * ax)


def smooth_sweep_plain(x, r, code, w, periodic, omega: float):
    stencil_cuda.note_plain("k1_sweep", x)
    diag, free = decode_code(code, w, x.dtype)
    inv_d = torch.where(
        free & (diag > 0),
        _full(omega, x.dtype, x.device) / torch.where(diag > 0, diag, 1.0),
        _zero(x),
    )
    return x + inv_d * (
        r - apply_restricted_plain(x, diag, free, w, periodic))


def residual_restricted_plain(x, r, code, w, periodic):
    stencil_cuda.note_plain("k1_resid", x)
    diag, free = decode_code(code, w, x.dtype)
    return torch.where(
        free, r - apply_restricted_plain(x, diag, free, w, periodic),
        _zero(x))


def residual_restrict_plain(x, r, code, w, periodic):
    stencil_cuda.note_plain("k1_restrict", x)
    diag, free = decode_code(code, w, x.dtype)
    resid = torch.where(free,
                        r - apply_restricted_plain(x, diag, free, w,
                                                   periodic),
                        _zero(x))
    for axis in (2, 1, 0):
        shape = list(resid.shape)
        shape[axis:axis + 1] = [shape[axis] // 2, 2]
        resid = resid.reshape(shape).sum(dim=axis + 1)
    return resid


# ---------------------------------------------------------------------------
# Dispatchers (kernel K1 on the card, plain form on the CPU)
# ---------------------------------------------------------------------------


def restricted_kernel(x, diag, with_dot: bool) -> str:
    """Which kernel serves ``apply_restricted`` on the card, a rule of the
    shapes alone: K5 (``"k5"``, one streaming pass down X) takes what it
    can do, an unbatched call with a full-array diag and no dot; K4
    (``"k4"``) takes a scalar or per-lane diag, the fused dot and every
    batched call."""
    if x.dim() == 3 and diag.dim() == 3 and not with_dot:
        return "k5"
    return "k4"


def _restricted_cuda(x, diag, free, w, periodic, with_dot: bool):
    if diag.dtype != x.dtype:
        diag = diag.to(x.dtype)
    if restricted_kernel(x, diag, with_dot) == "k5":
        return stencil_cuda.k5_matvec_stream(x, diag, free, w, periodic)
    return stencil_cuda.k4_matvec(x, diag, free, w, periodic,
                                  with_dot=with_dot)


def apply_restricted(x, diag, free, w, periodic):
    """Action of the free-set operator with explicit (diag, free) arrays:
    ``free ? diag*x - sum_f w_f x_nbr : 0``.  ``x`` is (X, Y, Z) or a batch
    (B, X, Y, Z) whose lanes each wrap on their own; ``diag`` is a 0-d
    tensor, a (B,) tensor (one scalar per lane) or a full array; ``free``
    is bool or int8.  K4 or K5 on the card (``restricted_kernel``), the
    plain form for a CPU tensor."""
    if _on_cpu(x):
        return apply_restricted_plain(x, diag, free, w, periodic)
    return _restricted_cuda(x, diag, free, w, periodic, False)


def apply_restricted_with_dot(x, diag, free, w, periodic):
    """``(A x, <x, A x>)`` with explicit (diag, free); the dot is 0-d, or
    (B,) for a batch.  On the card K4 fuses the reduction into the stencil
    pass (a deterministic two-stage sum per lane, no float atomics)."""
    if _on_cpu(x):
        return apply_restricted_with_dot_plain(x, diag, free, w, periodic)
    return _restricted_cuda(x, diag, free, w, periodic, True)


def apply_code(x, code, w, periodic):
    """Action of the free-set operator from the packed geometry."""
    if _on_cpu(x):
        return apply_code_plain(x, code, w, periodic)
    return stencil_cuda.k1_stencil("matvec", x, None, code, w, periodic)


def apply_code_with_dot(x, code, w, periodic):
    """``(A x, <x, A x>)``; on the card the reduction is fused into the
    stencil pass (a deterministic two-stage sum, no float atomics)."""
    if _on_cpu(x):
        return apply_code_with_dot_plain(x, code, w, periodic)
    return stencil_cuda.k1_stencil("matvec", x, None, code, w, periodic,
                                   with_dot=True)


def smooth_sweep(x, r, code, w, periodic, omega: float):
    """One damped-Jacobi sweep ``x + (omega/diag)*(r - A x)`` (free &
    diag>0; else x)."""
    if _on_cpu(x):
        return smooth_sweep_plain(x, r, code, w, periodic, omega)
    return stencil_cuda.k1_stencil("sweep", x, r, code, w, periodic,
                                   omega=omega)


def residual_restricted(x, r, code, w, periodic):
    """``free ? r - A x : 0`` in one pass."""
    if _on_cpu(x):
        return residual_restricted_plain(x, r, code, w, periodic)
    return stencil_cuda.k1_stencil("resid", x, r, code, w, periodic)


def residual_restrict(x, r, code, w, periodic):
    """``blocksum_2x2x2(free ? r - A x : 0)`` in one pass: the (X/2, Y/2,
    Z/2) coarse residual, the fine residual never written out.  Every
    extent must be even."""
    if _on_cpu(x):
        return residual_restrict_plain(x, r, code, w, periodic)
    return stencil_cuda.k1_stencil("restrict", x, r, code, w, periodic)


# ---------------------------------------------------------------------------
# X slabs: K1 on a ghost-padded slab
# ---------------------------------------------------------------------------

SLAB_PAD = 2  # planes on each side of a slab in K1's slab layout


def code_slab(code):
    """A slab's code in K1's slab layout: (X+4, Y, Z), two planes of -1
    (not free) on each side."""
    pad = _minus_one_bf16(code.device).expand(
        (SLAB_PAD,) + tuple(code.shape[1:]))
    return torch.cat([pad, code, pad])


def pad_slab(x, mesh=None, periodic_x: bool = False, ghosts: bool = True):
    """``x`` (X, Y, Z) copied into K1's slab layout (X+4, Y, Z), the outer
    planes 0; with ``ghosts``, planes 1 and X+2 from the neighbouring
    ranks (``fill_ghosts_``; with no mesh, the slab's own wrap or 0), else
    0."""
    X = x.shape[0]
    xp = torch.empty((X + 2 * SLAB_PAD,) + tuple(x.shape[1:]),
                     dtype=x.dtype, device=x.device)
    xp[:SLAB_PAD].zero_()
    xp[-SLAB_PAD:].zero_()
    xp[SLAB_PAD:-SLAB_PAD].copy_(x)
    if ghosts:
        fill_ghosts_(xp, SLAB_PAD - 1, X + SLAB_PAD, periodic_x, mesh)
    return xp


def slab_periodic(periodic) -> tuple:
    """K1's periodic flags on a slab: X clamped (the ghosts carry the
    wrap), Y and Z as the system's."""
    return (False, bool(periodic[1]), bool(periodic[2]))


def slab_interior(out):
    """The slab's planes of a K1 output in the slab layout (a contiguous
    view)."""
    return out[SLAB_PAD:-SLAB_PAD]


def slab_stencil(mode: str, x, r, code_halo, w, periodic, mesh,
                 omega: float = 0.9):
    """One K1 mode on this rank's slab (``x``, ``r``: (X, Y, Z); the code
    in the slab layout, ``code_slab``): the dispatchers above on the
    ghost-padded copies, K1 on the card, the plain form on the CPU.
    Returns the slab's output; ``"matvec_dot"`` returns ``(out, dot)``
    with the dot summed over the ranks; ``"restrict"`` the (X/2, Y/2, Z/2)
    coarse slab (X even)."""
    per = slab_periodic(periodic)
    xp = pad_slab(x, mesh, bool(periodic[0]))
    rp = None if r is None else pad_slab(r, ghosts=False)
    if mode == "matvec":
        return slab_interior(apply_code(xp, code_halo, w, per))
    if mode == "matvec_dot":
        out, dot = apply_code_with_dot(xp, code_halo, w, per)
        if mesh is not None:
            dot = mesh.allsum(dot)
        return slab_interior(out), dot
    if mode == "sweep":
        return slab_interior(smooth_sweep(xp, rp, code_halo, w, per, omega))
    if mode == "resid":
        return slab_interior(residual_restricted(xp, rp, code_halo, w, per))
    if mode == "restrict":
        return residual_restrict(xp, rp, code_halo, w, per)[1:-1]
    raise ValueError(f"unknown K1 mode {mode!r}")


def apply_restricted_slab(x, diag_halo, free_halo, w, periodic, mesh):
    """``apply_restricted`` of one volume on this rank's X slab: ``x``
    padded by one plane from the neighbouring ranks (the wrap or zeros at
    the end ranks), the operator run on the padded slab with X clamped
    (K5 on the card, the plain form on the CPU; ``diag_halo`` and
    ``free_halo`` padded once by ``parallel.halo.pad_x``, 0 on the ghost
    planes, whose outputs are dropped), the slab's planes kept."""
    xp = halo_exchange_x(x, bool(periodic[0]), mesh)
    out = apply_restricted(xp, diag_halo, free_halo, w,
                           slab_periodic(periodic))
    return out[1:-1]


@dataclasses.dataclass(frozen=True)
class StencilSystem:
    """A masked-Laplacian linear system in eliminated (free-set) form.

    The full system ``A_full x_full = b_full`` has identity rows on forced
    cells (inactive, Dirichlet).  We solve ``A z = r0`` on ``free`` with
    ``x_full = x_forced + z`` and ``r0 = free * (b_full - A_full x_forced)``;
    Hypre's criterion ``||b - A x||_2 / ||b_full||_2 <= eps``
    (``TortuosityHypre.cpp:686-688``) is reproduced with ``b_norm``.
    """

    code: torch.Tensor  # bf16 packed geometry (free ? count : -1)
    x_forced: torch.Tensor  # forced values; 0 on free cells (may be 0-d)
    r0_b: torch.Tensor  # b_full restricted to free rows (may be 0-d)
    b_norm: torch.Tensor  # ||b_full||_2, 0-d
    w: tuple
    periodic: tuple
    # X slabs: the rank's Mesh, the code in K1's slab layout, and the
    # global X extent of the volume where the mesh pads X (None: unpadded)
    mesh: object = None
    code_halo: torch.Tensor = None
    x_extent: int | None = None

    @property
    def free(self):
        return self.code > 0

    @property
    def diag(self):
        """Diagonal in the storage dtype, meaningful only under ``free``."""
        return decode_code(self.code, self.w, self.r0_b.dtype)[0]

    def apply(self, x):
        if self.mesh is not None:
            return slab_stencil("matvec", x, None, self.code_halo, self.w,
                                self.periodic, self.mesh)
        return apply_code(x, self.code, self.w, self.periodic)

    def apply_full(self, x):
        """``apply`` under the JAX package's other name: the operator
        already reads the neighbours from the full array."""
        return self.apply(x)

    def apply_with_dot(self, x):
        """``(A x, <x, A x>)``; on a slab the dot is summed over the
        ranks."""
        if self.mesh is not None:
            return slab_stencil("matvec_dot", x, None, self.code_halo,
                                self.w, self.periodic, self.mesh)
        return apply_code_with_dot(x, self.code, self.w, self.periodic)

    def initial_residual(self, x0_free):
        """r0 for the Krylov solve starting at z = x0_free (the operator
        reads neighbours from the full array, forced values included)."""
        x_start = self.x_forced + x0_free
        return torch.where(self.free, self.r0_b - self.apply(x_start),
                           _zero(x0_free))

    def assemble_solution(self, z):
        return self.x_forced + torch.where(self.free, z, _zero(z))

    def astype(self, dtype) -> "StencilSystem":
        """Cast the float fields; the packed bf16 geometry is dtype-free."""
        return dataclasses.replace(
            self,
            x_forced=self.x_forced.to(dtype),
            r0_b=self.r0_b.to(dtype),
            b_norm=self.b_norm.to(dtype),
        )


def _weights(dx):
    return tuple(1.0 / (float(d) * float(d)) for d in dx)


def make_tortuosity_system(active, direction: Axis, vlo: float, vhi: float,
                           dx=(1.0, 1.0, 1.0), dtype=torch.float64,
                           hi_plane: int | None = None,
                           mesh=None,
                           x_extent: int | None = None) -> StencilSystem:
    """Build the flow-through system for a percolation mask ``active`` (a
    bool tensor; the system lives on its device).

    Dirichlet vlo/vhi on the inlet/outlet planes of ``direction``, no-flux
    elsewhere, non-periodic.  ``hi_plane`` overrides the outlet plane index
    (a global index).  Under a ``mesh``, ``active`` is this rank's X slab
    of the (padded) global mask: the neighbour counts read the
    neighbouring ranks' planes, the inlet plane of X lives on rank 0, the
    outlet plane on the rank that holds it, and ``b_norm`` sums over the
    ranks; ``x_extent``, the volume's X extent before the padding, is kept
    for the multigrid schedule (``solve/slab_mg.py``).
    """
    periodic = (False, False, False)
    w = _weights(dx)
    active = active.to(torch.bool)
    dev = active.device
    shape = tuple(active.shape)
    n = shape[direction]
    x0 = 0
    if mesh is not None and direction == 0:
        n, x0 = n * mesh.size, n * mesh.rank
    hi = n - 1 if hi_plane is None else int(hi_plane)

    axes = neighbor_count_axes(active, periodic, mesh)
    nsum = axes[0] + axes[1] + axes[2]
    # an active cell with NO active neighbours is decoupled BEFORE the
    # Dirichlet overwrite (TortuosityHypreFill.F90:172-181 `cycle`s): an
    # isolated inlet-plane cell becomes an identity row, not a vlo row
    connected = active & (nsum > 0)

    idx = torch.arange(x0, x0 + shape[direction], device=dev).reshape(
        [-1 if a == direction else 1 for a in range(3)])
    on_lo = (idx == 0) & connected
    on_hi = (idx == hi) & connected
    dirichlet = on_lo | on_hi
    free = connected & ~dirichlet
    code = (pack_code(nsum, free) if uniform_w(w)
            else pack_code_axes(axes, free))

    x_forced = torch.where(on_lo, _full(vlo, dtype, dev),
                           torch.zeros(shape, dtype=dtype, device=dev))
    x_forced = torch.where(on_hi, _full(vhi, dtype, dev), x_forced)

    # rhs of free rows is identically 0: a 0-d scalar, not a volume
    r0_b = torch.zeros((), dtype=dtype, device=dev)
    n_lo = torch.sum(on_lo, dtype=dtype)
    n_hi = torch.sum(on_hi, dtype=dtype)
    if mesh is not None:
        n_lo, n_hi = mesh.allsum(n_lo), mesh.allsum(n_hi)
    b_norm = torch.sqrt(vlo * vlo * n_lo + vhi * vhi * n_hi)
    return StencilSystem(code=code, x_forced=x_forced, r0_b=r0_b,
                         b_norm=b_norm, w=w, periodic=periodic, mesh=mesh,
                         code_halo=None if mesh is None else code_slab(code),
                         x_extent=None if mesh is None else x_extent)


def make_cell_problem_system(active, direction_k: Axis, dx=(1.0, 1.0, 1.0),
                             dtype=torch.float64,
                             mesh=None) -> StencilSystem:
    """Build the periodic homogenisation cell problem for chi_k
    (``EffectiveDiffusivityHypre.cpp:213-399``).  ``active`` is (X, Y, Z),
    or a batch (B, X, Y, Z) of masks: then ``code`` and ``r0_b`` carry the
    batch dimension and ``b_norm`` is (B,).  Under a ``mesh``, ``active``
    is this rank's X slab of an (X, Y, Z) mask whose X the mesh divides
    (a periodic cell problem cannot be padded): ``m_minus``/``m_plus``
    read the X neighbours across the seams, rank 0's lower one from the
    last rank (the wrap), ``b_norm`` sums over the ranks, and the code is
    kept once more in K1's slab layout."""
    periodic = (True, True, True)
    w = _weights(dx)
    active = active.to(torch.bool)
    dev = active.device

    # every face contributes w_f to the diagonal (EffDiffFillMtx.F90:156-221):
    # packed count 6 everywhere (anisotropic: per-axis 2 each = 42)
    code_free = 6 if uniform_w(w) else 2 * 16 + 2 * 4 + 2
    code = torch.where(active,
                       torch.full((), code_free, dtype=torch.bfloat16,
                                  device=dev),
                       _minus_one_bf16(dev))

    m = active.to(dtype)
    mp = pad_halo(m, periodic) if mesh is None else pad_halo_slab(
        m, periodic, mesh)
    sl = [slice(1, -1)] * 3
    lo_sl, hi_sl = list(sl), list(sl)
    lo_sl[direction_k] = slice(0, -2)
    hi_sl[direction_k] = slice(2, None)
    m_minus = mp[(..., *lo_sl)]
    m_plus = mp[(..., *hi_sl)]

    inv_2d = 1.0 / (2.0 * float(dx[direction_k]))
    inv_d = 1.0 / float(dx[direction_k])
    # rhs = -(D+ - D-)/(2 dx) + (1 - m_-)/dx - (1 - m_+)/dx
    rhs = (-(m_plus - m_minus) * inv_2d + (1.0 - m_minus) * inv_d
           - (1.0 - m_plus) * inv_d)
    rhs = torch.where(active, rhs, torch.zeros((), dtype=dtype, device=dev))

    b2 = torch.sum(rhs * rhs, dim=(-3, -2, -1))
    b_norm = torch.sqrt(b2 if mesh is None else mesh.allsum(b2))
    return StencilSystem(code=code,
                         x_forced=torch.zeros((), dtype=dtype, device=dev),
                         r0_b=rhs, b_norm=b_norm, w=w, periodic=periodic,
                         mesh=mesh,
                         code_halo=None if mesh is None else code_slab(code))


def check_operator_properties(system: StencilSystem, active,
                              direction=None) -> dict:
    """Structural verification of the operator, the counterpart of
    ``TortuosityHypre::checkMatrixProperties``
    (``TortuosityHypre.cpp:896-982``), on the full system reconstructed
    from the matrix-free form: finite coefficients; positive diagonal on
    the free rows; for the tortuosity operator, zero rhs and zero row sum
    there.  Returns a dict of bools plus the ``row_sum`` tensor."""
    active = active.to(torch.bool)
    dtype = system.diag.dtype
    degree = weighted_degree(active, system.w, system.periodic, dtype)
    diag = system.diag.expand(active.shape)
    row_sum = torch.where(active, diag - degree, _zero(diag))

    interior = system.free
    out = {
        "finite": bool(
            torch.isfinite(diag).all()
            & torch.isfinite(system.r0_b).all()
            & torch.isfinite(system.x_forced).all()
        ),
        "diag_positive_on_free": bool(((diag > 0) | ~interior).all()),
        "rhs_zero_on_free": True,
        "row_sum": row_sum,
    }
    if not system.periodic[0]:
        # tortuosity operator: zero row sum on active interior rows
        out["rhs_zero_on_free"] = bool(
            ((system.r0_b == 0) | ~interior).all())
        out["row_sum_zero_on_free"] = bool(
            ((row_sum.abs() < 1e-12) | ~interior).all())
    return out
