"""Boundary-flux integration (``TortuosityHypre::global_fluxes``,
``TortuosityHypre.cpp:1000-1134``) as plain tensor reductions."""

from __future__ import annotations

import torch


def _plane(x, axis, index):
    sl = [slice(None)] * x.ndim
    sl[axis] = index
    return x[tuple(sl)]


def boundary_fluxes(phi, active, direction: int, dx=(1.0, 1.0, 1.0)):
    """(flux_in, flux_out) at the lo/hi domain faces of ``direction``, as
    0-d tensors in the dtype of ``phi``.

    At the lo face, for each active boundary cell whose inward neighbour is
    also active, flux = -(phi_inner - phi_boundary)/dx, summed; mirrored at
    the hi face; each scaled by the face-area element
    (``TortuosityHypre.cpp:1066-1133``).
    """
    direction = int(direction)
    a = active.to(torch.bool)
    d = float(dx[direction])
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)

    phi_lo, phi_lo_in = _plane(phi, direction, 0), _plane(phi, direction, 1)
    m_lo = _plane(a, direction, 0) & _plane(a, direction, 1)
    flux_in = torch.sum(torch.where(m_lo, -(phi_lo_in - phi_lo) / d, zero))

    phi_hi, phi_hi_in = _plane(phi, direction, -1), _plane(phi, direction, -2)
    m_hi = _plane(a, direction, -1) & _plane(a, direction, -2)
    flux_out = torch.sum(torch.where(m_hi, -(phi_hi - phi_hi_in) / d, zero))

    others = [ax for ax in range(3) if ax != direction]
    face_area_element = float(dx[others[0]]) * float(dx[others[1]])
    return flux_in * face_area_element, flux_out * face_area_element


def active_boundary_counts(active, direction: int):
    """Number of active cells on the lo/hi faces
    (``TortuosityHypre.cpp:1039-1040``)."""
    a = active.to(torch.bool)
    direction = int(direction)
    return (int(_plane(a, direction, 0).sum()),
            int(_plane(a, direction, -1).sum()))
