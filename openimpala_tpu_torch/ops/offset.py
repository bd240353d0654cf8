"""Variable-coefficient offset stencils (the counterpart of
``openimpala_tpu/ops/offset_pallas.py``): the operators of the
smoothed-aggregation coarse levels (``solve/sa.py::OffsetLevel``),

    (A x)(i) = sum_t c_t(i) * x(i + o_t),     27 to 125 taps,

with the coefficients packed as one (X, T, Y, Z) array in
``order_offsets`` order: (0,0,0) at t=0, then the rest of the l_inf<=1
ball (the filtered smoother's prefix, ``n_taps = nn``), then the wider
taps.  Every read wraps: the probed operator carries a zero coefficient
wherever an offset crosses a clamped boundary.

Modes, with d the (0,0,0) tap:
  apply : out = A x                    (``n_taps`` < T: the leading taps)
  resid : out = d > 0 ? r - A x : 0
  sweep : out = x + (d > 0 ? omega / d : 0) * (r - A x)

Dispatch rule: ``offset_apply``, ``offset_resid`` and ``offset_sweep``
launch the CUDA kernel K3 (``ops/offset_cuda.py``) for a CUDA tensor and
run the plain PyTorch form beside them only for a CPU tensor.

X slabs (the counterpart of ``ops/stencil.py::slab_stencil``): a level's
coefficients are copied once into a ``(X_local + 2R, T, Y, Z)`` layout
(``parallel.halo.pad_x``, R = the largest X reach of its taps, the ghost
planes' coefficients 0), and ``slab_offset`` pads ``x`` by R planes from the
neighbouring ranks (``halo_exchange_x``: the wrap or zeros at the end
ranks), runs the dispatchers above unchanged on the padded slab and keeps
its planes ``[R, R + X_local)``.  K3 wraps every axis by a true modulus,
but an interior cell reads at most R planes away, so it never wraps X; an
output cell reads only its own coefficients, so the ghost planes' outputs
are simply dropped.
"""

from __future__ import annotations

import torch

from ..parallel.halo import halo_exchange_x, pad_x
from . import offset_cuda, stencil_cuda
from .stencil import _full, _on_cpu, _zero


def order_offsets(offsets):
    """Canonical packing order: (0,0,0) first, then the rest of the
    l_inf<=1 ball, then wider taps.  Returns (ordered_offsets, nn_count)."""
    offsets = list(offsets)
    centre = [(0, 0, 0)] if (0, 0, 0) in offsets else []
    nn = sorted(o for o in offsets
                if max(abs(c) for c in o) <= 1 and o != (0, 0, 0))
    far = sorted(o for o in offsets if max(abs(c) for c in o) > 1)
    ordered = tuple(centre + nn + far)
    return ordered, len(centre) + len(nn)


def shift(x, o):
    """x(i + o), wrapped on every axis."""
    return torch.roll(x, (-o[0], -o[1], -o[2]), dims=(0, 1, 2))


def _diag(packed, offsets, dtype):
    return packed[:, offsets.index((0, 0, 0))].to(dtype)


# ---------------------------------------------------------------------------
# Plain PyTorch forms of kernel K3: the reference the kernel is held against
# on the card, and the CPU path.  A call with a CUDA tensor is counted in
# ``stencil_cuda.plain_on_cuda``.
# ---------------------------------------------------------------------------


def offset_apply_plain(x, packed, offsets, n_taps=None):
    """Sum of rolled multiplies over the leading ``n_taps`` taps, in tap
    order, each coefficient cast to ``x.dtype``."""
    stencil_cuda.note_plain("k3_apply", x)
    n = len(offsets) if n_taps is None else n_taps
    out = torch.zeros_like(x)
    for t in range(n):
        out = out + packed[:, t].to(x.dtype) * shift(x, offsets[t])
    return out


def offset_resid_plain(x, r, packed, offsets):
    stencil_cuda.note_plain("k3_resid", x)
    d = _diag(packed, offsets, x.dtype)
    return torch.where(d > 0, r - offset_apply_plain(x, packed, offsets),
                       _zero(x))


def offset_sweep_plain(x, r, packed, offsets, omega: float):
    stencil_cuda.note_plain("k3_sweep", x)
    d = _diag(packed, offsets, r.dtype)
    inv_d = torch.where(
        d > 0, _full(omega, r.dtype, r.device) / torch.where(d > 0, d, 1.0),
        _zero(r))
    return x + inv_d * (r - offset_apply_plain(x, packed, offsets))


# ---------------------------------------------------------------------------
# Dispatchers (kernel K3 on the card, plain form on the CPU)
# ---------------------------------------------------------------------------


def offset_apply(x, packed, offsets, n_taps=None):
    if _on_cpu(x):
        return offset_apply_plain(x, packed, offsets, n_taps)
    return offset_cuda.k3_offset("apply", x, None, packed, offsets,
                                 n_taps=n_taps)


def offset_resid(x, r, packed, offsets):
    if _on_cpu(x):
        return offset_resid_plain(x, r, packed, offsets)
    return offset_cuda.k3_offset("resid", x, r, packed, offsets)


def offset_sweep(x, r, packed, offsets, omega: float):
    if _on_cpu(x):
        return offset_sweep_plain(x, r, packed, offsets, omega)
    return offset_cuda.k3_offset("sweep", x, r, packed, offsets, omega=omega)


# ---------------------------------------------------------------------------
# X slabs: K3 on a slab padded by R exchanged planes
# ---------------------------------------------------------------------------


def x_reach(offsets) -> int:
    """R: the largest |o_x| among ``offsets``, the halo width a slab needs."""
    return max(abs(o[0]) for o in offsets)


def slab_offset(mode: str, x, r, padded, offsets, width: int,
                periodic_x: bool, mesh, n_taps=None, omega: float = 0.9):
    """One K3 mode (``"apply"``, ``"resid"``, ``"sweep"``) on this rank's
    slab: ``x`` and ``r`` (X, Y, Z), ``padded`` the coefficients in the
    slab layout (``pad_x`` with ``width`` = R); the dispatchers on the
    padded copies (K3 on the card, the plain form on the CPU).  Returns the
    slab's (X, Y, Z) output."""
    X = x.shape[0]
    xp = halo_exchange_x(x, periodic_x, mesh, width)
    if mode == "apply":
        out = offset_apply(xp, padded, offsets, n_taps)
    else:
        rp = pad_x(r, width)  # read only at the output cell
        if mode == "resid":
            out = offset_resid(xp, rp, padded, offsets)
        elif mode == "sweep":
            out = offset_sweep(xp, rp, padded, offsets, omega)
        else:
            raise ValueError(f"unknown K3 mode {mode!r}")
    return out[width:width + X]
