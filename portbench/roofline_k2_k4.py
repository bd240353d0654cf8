"""The compulsory bytes of a K2 or K4 launch, beside K1's in
``roofline.py`` and at the same peak.

K2 (``csrc/k2_conductance.cu``) reads ``x``, the three face conductances
and ``diag`` and writes ``out`` (six fields of the dtype: 24 B a cell in
float32); ``sweep`` also reads ``r`` (28).  A ``cheby`` step of the
coarsest level's Chebyshev solve reads ``d``, the three conductances,
``diag``, ``res`` and ``x`` and writes ``res``, ``d_new`` and ``x`` (ten
fields: 40 B a cell in float32, 80 in float64); ``cheby_init`` reads
``r`` and ``diag`` and writes ``res``, ``d_new`` and ``x`` (five: 20 B,
40).  K4 (``csrc/k4_matvec.cu``)
reads ``x``, the full ``diag`` and the one-byte ``free`` and writes
``out`` (13 B a cell in float32, 25 in float64); its dot's partials are a
few bytes a block.  An extent is ``(X, Y, Z)``, or ``(B, X, Y, Z)`` for a
batch of K4, as the package's ``stencil_cuda.launches_at`` keys it.
"""

from __future__ import annotations

import math

from .roofline import ITEMSIZE

# fields of the dtype one launch moves, by mode
K2_FIELDS = {"matvec": 6, "sweep": 7, "cheby": 10, "cheby_init": 5}
K2_MODES = tuple(K2_FIELDS)


def k2_bytes(mode: str, shape, dtype: str) -> float:
    """Compulsory bytes of one K2 launch on ``shape``."""
    if mode not in K2_FIELDS:
        raise ValueError(f"unknown K2 mode {mode!r}")
    return K2_FIELDS[mode] * ITEMSIZE[dtype] * math.prod(shape)


def k4_bytes(shape, dtype: str) -> float:
    """Compulsory bytes of one K4 launch (with or without the dot) on
    ``shape``, the whole batch's extent."""
    return (3 * ITEMSIZE[dtype] + 1) * math.prod(shape)


def launch_bytes(launches_at, kernel: str) -> float:
    """Bytes of every ``kernel`` (``"k2"`` or ``"k4"``) launch in a
    ``(name, extent) -> count`` counter."""
    total = 0.0
    for (name, shape), count in launches_at.items():
        head, _, rest = name.partition("_")
        if head != kernel:
            continue
        mode, dtype = rest.rsplit("_", 1)
        if kernel == "k2":
            total += count * k2_bytes(mode, shape, dtype)
        else:
            total += count * k4_bytes(shape, dtype)
    return total
