"""Carry solver state across from the JAX package: build the port's
objects from the leaves of a JAX ``StencilSystem`` or Galerkin level, given
as numpy arrays.  Used by the parity tests to run both solvers on the very
same system."""

from __future__ import annotations

import numpy as np
import torch

from .ops.stencil import StencilSystem
from .solve.preconditioners import ConductanceLevel
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


def conductance_level_from_numpy(diag, cx, cy, cz,
                                 device=None) -> ConductanceLevel:
    """One Galerkin level of the port from a JAX ConductanceLevel's
    arrays."""
    dev = resolve_device(device)
    return ConductanceLevel(diag=_tensor(diag, dev), cx=_tensor(cx, dev),
                            cy=_tensor(cy, dev), cz=_tensor(cz, dev))
