"""Carry solver state across from the JAX package: build the port's
objects from the leaves of a JAX ``StencilSystem``, ``LaneSystem``, Galerkin
level, Chebyshev or smoothed-aggregation preconditioner, given as numpy
arrays.
Used by the parity tests to run both solvers on the very same system."""

from __future__ import annotations

import numpy as np
import torch

from .ops.stencil import StencilSystem
from .solve.lanes import LaneSystem
from .solve.preconditioners import (
    ChebyshevPreconditioner,
    ConductanceLevel,
    MGLevel,
)
from .solve.sa import OffsetLevel, SAMGPreconditioner
from .utils.common import resolve_device


def _tensor(a, device):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16, which torch.from_numpy refuses: same bits
        # through int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def system_from_numpy(code, x_forced, r0_b, b_norm, w, periodic,
                      device=None) -> StencilSystem:
    """The port's StencilSystem from the JAX system's leaves."""
    dev = resolve_device(device)
    return StencilSystem(
        code=_tensor(code, dev), x_forced=_tensor(x_forced, dev),
        r0_b=_tensor(r0_b, dev), b_norm=_tensor(b_norm, dev),
        w=tuple(float(v) for v in w),
        periodic=tuple(bool(p) for p in periodic),
    )


def lane_system_from_numpy(code, x_forced, r0_b, b_norm, w, periodic,
                           device=None) -> LaneSystem:
    """The port's LaneSystem from a JAX LaneSystem's leaves (``r0_b`` is
    (L, X, Y, Z), ``b_norm`` (L,))."""
    dev = resolve_device(device)
    return LaneSystem(
        code=_tensor(code, dev), x_forced=_tensor(x_forced, dev),
        r0_b=_tensor(r0_b, dev), b_norm=_tensor(b_norm, dev),
        w=tuple(float(v) for v in w),
        periodic=tuple(bool(p) for p in periodic),
    )


def conductance_level_from_numpy(diag, cx, cy, cz,
                                 device=None) -> ConductanceLevel:
    """One Galerkin level of the port from a JAX ConductanceLevel's
    arrays."""
    dev = resolve_device(device)
    return ConductanceLevel(diag=_tensor(diag, dev), cx=_tensor(cx, dev),
                            cy=_tensor(cy, dev), cz=_tensor(cz, dev))


def offset_level_from_numpy(packed, offsets, nn, device=None) -> OffsetLevel:
    """One smoothed-aggregation level of the port from a JAX OffsetLevel's
    packed (X, T, Y, Z) coefficients and its static fields."""
    dev = resolve_device(device)
    return OffsetLevel(
        packed=_tensor(packed, dev).contiguous(),
        offsets=tuple(tuple(int(c) for c in o) for o in offsets),
        nn=int(nn))


def sa_preconditioner_from_numpy(code, w, periodic, dinv0, levels,
                                 device=None, **static) -> SAMGPreconditioner:
    """The port's SAMGPreconditioner from a JAX one's leaves: the fine
    level's ``code``, ``w``, ``periodic``, the ``dinv0`` array, ``levels`` as
    ``(packed, offsets, nn)`` triples, and the static fields (``nu1``,
    ``nu2``, ``omega``, ``coarse_sweeps``, ``sa_depth``, ``om_sa``,
    ``cycle``, ``w_depth``) by keyword."""
    dev = resolve_device(device)
    fine = MGLevel(code=_tensor(code, dev),
                   w=tuple(float(v) for v in w),
                   periodic=tuple(bool(p) for p in periodic))
    return SAMGPreconditioner(
        fine=fine, dinv0=_tensor(dinv0, dev),
        levels=tuple(offset_level_from_numpy(*lvl, device=dev)
                     for lvl in levels),
        **static)


def chebyshev_preconditioner_from_numpy(diag, free, w, periodic, degree, hi,
                                        ratio, device=None
                                        ) -> ChebyshevPreconditioner:
    """The port's ChebyshevPreconditioner from a JAX one's leaves (``diag``,
    ``free``) and static fields, so that both apply the same polynomial."""
    dev = resolve_device(device)
    return ChebyshevPreconditioner(
        diag=_tensor(diag, dev).contiguous(),
        free=_tensor(free, dev).to(torch.bool),
        w=tuple(float(v) for v in w),
        periodic=tuple(bool(p) for p in periodic),
        degree=int(degree), hi=float(hi), ratio=float(ratio))
