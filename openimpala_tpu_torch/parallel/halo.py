"""Ghost layers around a volume or an X slab, periodic or clamped (the
port's AMReX ``FillBoundary``, reference
``src/props/TortuosityHypre.cpp:584-585``).

``pad_halo`` is the single-device form, one cell wide.
``halo_exchange_x`` is the slab form: each rank sends its first and last
``width`` X planes to its neighbours (``Mesh.exchange``; ``width`` 2 for
the offset stencils of the smoothed-aggregation levels, whose X taps reach
two planes).  A slab thinner than ``width`` cannot be served by its
nearest neighbours and raises: such a level is gathered instead
(``solve/slab_sa.py``), never exchanged two ranks away.
``slab_stencil_apply`` wraps a stencil on padded blocks into an operation
on slabs, the counterpart of the JAX package's
``shard_map_stencil_apply``.  ``roll_x`` is ``torch.roll`` along X of the
global array, done on slabs.
"""

from __future__ import annotations

import torch


def pad_halo(x: torch.Tensor, periodic) -> torch.Tensor:
    """Pad a (X, Y, Z) tensor to (X+2, Y+2, Z+2); leading dimensions (a
    batch of volumes) pass through unpadded.

    Periodic axes wrap; clamped axes are zero-filled, which encodes the
    reference's "outside the domain = inactive / no-flux" convention.
    Built from ``torch.cat`` (``F.pad(mode="circular")`` wants a 5-D input
    for 3-D padding).
    """
    lead = x.dim() - 3
    for axis, per in enumerate(periodic, start=lead):
        x = _pad_axis(x, axis, per)
    return x


def _pad_axis(x, axis: int, periodic: bool):
    n = x.shape[axis]
    if periodic:
        lo, hi = x.narrow(axis, n - 1, 1), x.narrow(axis, 0, 1)
    else:
        shape = list(x.shape)
        shape[axis] = 1
        lo = hi = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([lo, x, hi], dim=axis)


def halo_exchange_x(x_local, periodic_x: bool, mesh, width: int = 1):
    """``(X_local + 2 width, Y, Z)``: the first ``width`` planes are the
    previous rank's last planes, the last ``width`` the next rank's first
    planes.  The end ranks receive the wrapped planes (periodic) or zeros
    (clamped); with no mesh, or one rank, the wrap is the slab's own (the
    JAX function's single-device branch).  ``X_local`` must be at least
    ``width``."""
    X = x_local.shape[0]
    if X < width:
        raise ValueError(f"a slab of {X} plane(s) cannot fill a halo of "
                         f"{width}: gather the level instead")
    xp = x_local.new_empty((X + 2 * width,) + tuple(x_local.shape[1:]))
    xp[width:X + width].copy_(x_local)
    return fill_ghosts_(xp, width - 1, X + width, periodic_x, mesh, width)


def fill_ghosts_(xp, lo: int, hi: int, periodic_x: bool, mesh,
                 width: int = 1):
    """Write the ghost planes ``xp[lo - width + 1 : lo + 1]`` and
    ``xp[hi : hi + width]`` of a padded slab in place from the neighbours'
    interior planes (``xp[lo + 1]`` is this rank's first plane,
    ``xp[hi - 1]`` its last)."""
    glo_v = xp[lo + 1 - width:lo + 1]
    ghi_v = xp[hi:hi + width]
    first, last = xp[lo + 1:lo + 1 + width], xp[hi - width:hi]
    if mesh is None:  # the slab's own wrap, or zeros
        if periodic_x:
            glo_v.copy_(last)
            ghi_v.copy_(first)
        else:
            glo_v.zero_()
            ghi_v.zero_()
        return xp
    glo, ghi = mesh.exchange(first, last, periodic_x)
    glo_v.copy_(glo)
    ghi_v.copy_(ghi)
    return xp


def pad_x(t, width: int = 1, lo=None):
    """``t`` with ``width`` planes of 0 (False) on each side of X
    (contiguous), the lower ones ``lo`` where given: the layout of a
    slab's fixed fields (coefficients, diagonals, masks) beside a halo of
    that width, built once."""
    z = t.new_zeros((width,) + tuple(t.shape[1:]))
    return torch.cat([z if lo is None else lo, t, z]).contiguous()


def pad_halo_slab(x, periodic, mesh):
    """``pad_halo`` of a slab: the X ghosts from the neighbours, Y and Z
    wrapped or zero-filled on the slab itself."""
    x = halo_exchange_x(x, periodic[0], mesh)
    for axis in (1, 2):
        x = _pad_axis(x, axis, periodic[axis])
    return x


def roll_x(x, shift: int, mesh):
    """``torch.roll(global, shift, dims=0)`` on slabs, ``shift`` +1 or -1:
    the wrapped plane crosses from the last rank to the first."""
    if mesh is None:
        return torch.roll(x, shift, dims=0)
    xp = halo_exchange_x(x, True, mesh)
    return xp[:-2] if shift == 1 else xp[2:]


def slab_stencil_apply(apply_padded, mesh, periodic, n_field_args: int = 1):
    """Wrap a stencil on padded blocks into an operation on X slabs.

    ``apply_padded(*padded_fields)`` takes (X_local+2, Y+2, Z+2) blocks and
    returns the (X_local, Y, Z) interior result.  The returned callable
    takes this rank's (X_local, Y, Z) slabs and does the X exchange
    (``halo_exchange_x``) before it, as the JAX package's
    ``shard_map_stencil_apply`` does with ``ppermute``."""

    def apply(*fields):
        if len(fields) != n_field_args:
            raise ValueError(f"expected {n_field_args} fields, got "
                             f"{len(fields)}")
        return apply_padded(*(pad_halo_slab(f, periodic, mesh)
                              for f in fields))

    return apply
