"""The yardstick of the kernel rooflines: the published peak, and the
compulsory bytes of a K1 launch.

A frozen copy of the arithmetic of the package's ``ops/stencil_cuda.py::
k1_cost``: each launch reads ``x`` and the bf16 ``code`` once and writes
``out`` once; ``resid``, ``sweep`` and ``restrict`` also read ``r``;
``restrict`` writes an eighth of the cells.  K1 is bound by bytes (about
one operation per byte), so its roofline is bytes over the peak.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"f32": 4, "f64": 8}
K1_MODES = ("matvec", "matvec_dot", "resid", "sweep", "restrict")


def k1_bytes(mode: str, shape, dtype: str) -> float:
    """Compulsory bytes of one K1 launch on ``shape`` (the input's
    extent), ``dtype`` ``"f32"`` or ``"f64"``."""
    if mode not in K1_MODES:
        raise ValueError(f"unknown K1 mode {mode!r}")
    es = ITEMSIZE[dtype]
    per_cell = es + 2 + (es / 8 if mode == "restrict" else es)
    if mode not in ("matvec", "matvec_dot"):
        per_cell += es
    return per_cell * math.prod(shape)


def parse_k1(name: str):
    """(mode, dtype) of a K1 launch counter name such as
    ``k1_matvec_dot_f32``; None for any other kernel."""
    if not name.startswith("k1_"):
        return None
    body, dtype = name[3:].rsplit("_", 1)
    if body not in K1_MODES or dtype not in ITEMSIZE:
        return None
    return body, dtype


def k1_launch_bytes(launches_route_at) -> float:
    """Bytes of every K1 launch in a ``(name, route, shape) -> count``
    counter."""
    total = 0.0
    for (name, _route, shape), count in launches_route_at.items():
        parsed = parse_k1(name)
        if parsed is not None:
            total += count * k1_bytes(parsed[0], shape, parsed[1])
    return total
