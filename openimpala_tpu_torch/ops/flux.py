"""Boundary-flux integration (``TortuosityHypre::global_fluxes``,
``TortuosityHypre.cpp:1000-1134``) and the D_eff tensor integrand
(``calculate_Deff_tensor_homogenization``, ``Diffusion.cpp:60-167``) as
plain tensor reductions."""

from __future__ import annotations

import torch

from ..parallel.halo import halo_exchange_x, pad_halo, pad_halo_slab


def _plane(x, axis, index):
    sl = [slice(None)] * x.ndim
    sl[axis] = index
    return x[tuple(sl)]


def boundary_fluxes(phi, active, direction: int, dx=(1.0, 1.0, 1.0),
                    mesh=None, extent: int | None = None):
    """(flux_in, flux_out) at the lo/hi domain faces of ``direction``, as
    0-d tensors in the dtype of ``phi``.

    At the lo face, for each active boundary cell whose inward neighbour is
    also active, flux = -(phi_inner - phi_boundary)/dx, summed; mirrored at
    the hi face; each scaled by the face-area element
    (``TortuosityHypre.cpp:1066-1133``).  On an axis one cell long the
    inner planes are the boundary planes themselves (the JAX package's
    indices clamp to the axis), so both face terms are 0.

    Under a ``mesh``, ``phi`` and ``active`` are this rank's X slabs of
    the global fields and each face's sum is summed over the ranks that
    hold it; ``extent``: the original X extent (the hi face of X is plane
    ``extent - 1``, before the padding of the last slab).
    """
    if mesh is not None:
        return _boundary_fluxes_slab(phi, active, int(direction), dx, mesh,
                                     extent)
    direction = int(direction)
    a = active.to(torch.bool)
    d = float(dx[direction])
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    n = phi.shape[direction]
    lo_in, hi_in = min(1, n - 1), max(-2, -n)

    phi_lo = _plane(phi, direction, 0)
    phi_lo_in = _plane(phi, direction, lo_in)
    m_lo = _plane(a, direction, 0) & _plane(a, direction, lo_in)
    flux_in = torch.sum(torch.where(m_lo, -(phi_lo_in - phi_lo) / d, zero))

    phi_hi = _plane(phi, direction, -1)
    phi_hi_in = _plane(phi, direction, hi_in)
    m_hi = _plane(a, direction, -1) & _plane(a, direction, hi_in)
    flux_out = torch.sum(torch.where(m_hi, -(phi_hi - phi_hi_in) / d, zero))

    others = [ax for ax in range(3) if ax != direction]
    face_area_element = float(dx[others[0]]) * float(dx[others[1]])
    return flux_in * face_area_element, flux_out * face_area_element


def _boundary_fluxes_slab(phi, active, direction, dx, mesh, extent):
    """``boundary_fluxes`` on X slabs.  Along Y or Z every rank holds its
    part of both faces; along X the faces are the global planes 0 and
    ``extent - 1``, read with one ghost plane on each side of the slab
    (the inner plane may sit on the neighbouring rank)."""
    if direction != 0:
        fin, fout = boundary_fluxes(phi, active, direction, dx)
        return mesh.allsum(fin), mesh.allsum(fout)
    X = phi.shape[0]
    n = X * mesh.size if extent is None else int(extent)
    x0 = X * mesh.rank
    php = halo_exchange_x(phi, False, mesh)
    ap = halo_exchange_x(active.to(torch.bool), False, mesh)
    d = float(dx[0])
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    lo_in, hi_in = min(1, n - 1), max(n - 2, 0)
    flux_in = flux_out = zero
    if x0 <= 0 < x0 + X:  # +1: the padded slab's plane of global g
        b, i = 1 - x0, lo_in - x0 + 1
        flux_in = torch.sum(torch.where(ap[b] & ap[i],
                                        -(php[i] - php[b]) / d, zero))
    if x0 <= n - 1 < x0 + X:
        b, i = n - 1 - x0 + 1, hi_in - x0 + 1
        flux_out = torch.sum(torch.where(ap[b] & ap[i],
                                         -(php[b] - php[i]) / d, zero))
    face = float(dx[1]) * float(dx[2])
    return mesh.allsum(flux_in) * face, mesh.allsum(flux_out) * face


def active_boundary_counts(active, direction: int):
    """Number of active cells on the lo/hi faces
    (``TortuosityHypre.cpp:1039-1040``)."""
    a = active.to(torch.bool)
    direction = int(direction)
    return (int(_plane(a, direction, 0).sum()),
            int(_plane(a, direction, -1).sum()))


def _central_grad(chi_p, axis, inv_2d):
    """Central difference of a periodic-padded field along ``axis`` (of the
    last three dimensions)."""
    sl_lo = [slice(1, -1)] * 3
    sl_hi = [slice(1, -1)] * 3
    sl_lo[axis] = slice(0, -2)
    sl_hi[axis] = slice(2, None)
    return (chi_p[(..., *sl_hi)] - chi_p[(..., *sl_lo)]) * inv_2d


def deff_integrand_sum(chi_x, chi_y, chi_z, active, dx=(1.0, 1.0, 1.0),
                       mesh=None):
    """Raw 3x3 sums of the homogenisation integrand over active cells:

        S_ab = sum_{active} (delta_ab - d(chi_b)/d(xi_a))

    with central differences on periodically ghost-filled chi fields
    (``Diffusion.cpp:98-142``).  The fields are (X, Y, Z), or batches
    (B, X, Y, Z) with ``active`` alike; returns a (3, 3) tensor, or
    (B, 3, 3), in the dtype of the chi fields.  Divide by the TOTAL number
    of domain cells (not active cells) for D_eff (``Diffusion.cpp:152-158``).
    Under a ``mesh`` the fields are this rank's X slabs: the X gradient
    reads the neighbouring ranks' planes across the seams (the wrap
    between the last rank and rank 0), and the sums are summed over the
    ranks, the same bits on every rank.
    """
    a = active.to(torch.bool)
    periodic = (True, True, True)
    inv2 = [1.0 / (2.0 * float(d)) for d in dx]
    zero = torch.zeros((), dtype=chi_x.dtype, device=chi_x.device)
    vol = (-3, -2, -1)

    n_active = torch.sum(a, dim=vol, dtype=chi_x.dtype)
    cols = []
    for chi in (chi_x, chi_y, chi_z):  # one padded field alive at a time
        chi_p = (pad_halo(chi, periodic) if mesh is None
                 else pad_halo_slab(chi, periodic, mesh))
        cols.append([torch.sum(torch.where(
            a, -_central_grad(chi_p, axis_a, inv2[axis_a]), zero), dim=vol)
            for axis_a in range(3)])
    rows = []
    for axis_a in range(3):
        row = [cols[b][axis_a] + n_active if axis_a == b else cols[b][axis_a]
               for b in range(3)]
        rows.append(torch.stack(row, dim=-1))
    out = torch.stack(rows, dim=-2)
    return out if mesh is None else mesh.allsum(out)
