"""Launcher of K3 (``csrc/k3_offset.cu``), the hand-written CUDA kernel that
replaces ``openimpala_tpu/ops/offset_pallas.py::offset_stencil_pallas``: the
27-to-125-tap variable-coefficient offset stencil of the smoothed-
aggregation coarse levels, in modes apply, resid and sweep.

Bound on an H100: bytes.  Compulsory traffic per cell, each input read
once and the output written once, is ``n_taps * sizeof(coeff) + sizeof(x)
+ sizeof(out)`` (``+ sizeof(r)`` for resid and sweep) for ``2 * n_taps``
flops: 140 B per cell for a 33-tap float32 apply.

The library is built and loaded by ``ops/stencil_cuda.py`` (one ``nvcc``
per source, on first use); every launch adds one to
``stencil_cuda.launches["k3_<mode>_<f32|f64>"]``, an apply of a leading
part of the taps to ``"k3_apply_prefix_<f32|f64>"``, and one to
``stencil_cuda.launches_at[(name, (X, Y, Z))]``, which splits the same
launches by the level's extent (``stencil_cuda._count``: nothing on a
thread inside ``stencil_cuda.uncounted()``; a CUDA graph's replays add the
counts its capture made, ``utils/graphs.py``).
"""

from __future__ import annotations

import functools

import torch

from . import stencil_cuda as sc

K3_MODES = {"apply": 0, "resid": 1, "sweep": 2}
K3_MAX_TAPS = 125  # MAX_TAPS of csrc/k3_offset.cu: every offset in [-2, 2]^3


@functools.lru_cache(maxsize=256)
def _taps_bytes(offsets: tuple) -> bytes:
    """The taps as int8 (dx, dy, dz) triples."""
    flat = [int(v) for o in offsets for v in o]
    if any(not -128 <= v <= 127 for v in flat):
        raise ValueError("K3: an offset component is outside int8")
    return bytes(v & 0xFF for v in flat)


def k3_cost(name: str, n_taps: int, coeff_bytes: int, x_bytes: int):
    """(compulsory bytes, flops) per cell of one K3 launch counted under
    ``name``: the taps' coefficients, x once, out once, r for resid and
    sweep; 2 flops per tap."""
    extra = x_bytes if ("resid" in name or "sweep" in name) else 0
    return n_taps * coeff_bytes + 2 * x_bytes + extra, 2 * n_taps


def k3_offset(mode: str, x, r, packed, offsets, n_taps=None,
              omega: float = 0.9):
    """Launch K3 on the current stream.

    ``x`` (and ``r`` for resid and sweep): float32/float64, contiguous
    (X, Y, Z) on the current CUDA device.  ``packed``: contiguous
    (X, T, Y, Z) coefficients, bfloat16 or ``x``'s dtype, tap ``t``
    belonging to ``offsets[t]``.  ``n_taps``: use the leading taps only.
    resid and sweep need the (0,0,0) tap among them.  Returns ``out``."""
    if mode not in K3_MODES:
        raise ValueError(f"unknown K3 mode {mode!r}")
    sc._check_x(x, "K3")
    X, Y, Z = x.shape
    offsets = tuple(offsets)  # of (dx, dy, dz) tuples
    T = len(offsets)
    n = T if n_taps is None else int(n_taps)
    if not 1 <= n <= T:
        raise ValueError(f"K3: n_taps={n} outside 1..{T}")
    if n > K3_MAX_TAPS:
        raise ValueError(f"K3: {n} taps, the kernel takes {K3_MAX_TAPS}")
    if packed is None or not packed.is_cuda or packed.device != x.device:
        raise ValueError("K3: packed must be a CUDA tensor on x's device")
    if tuple(packed.shape) != (X, T, Y, Z):
        raise ValueError(f"K3: packed shape {tuple(packed.shape)} != "
                         f"{(X, T, Y, Z)}")
    if not packed.is_contiguous():
        raise ValueError("K3: packed must be contiguous")
    if packed.dtype not in (torch.bfloat16, x.dtype):
        raise ValueError(f"K3: packed must be bfloat16 or {x.dtype} "
                         f"(got {packed.dtype})")
    diag_tap = 0
    if mode != "apply":
        sc._check(r, "r", like=x, dtype=x.dtype)
        if (0, 0, 0) not in offsets[:n]:
            raise ValueError(f"K3 {mode}: no (0,0,0) tap among the taps used")
        diag_tap = offsets.index((0, 0, 0))
    lib = sc._load("k3")
    out = torch.empty_like(x)
    err = lib.k3_launch(
        K3_MODES[mode], int(x.dtype == torch.float64),
        int(packed.dtype == torch.bfloat16), x.data_ptr(),
        None if mode == "apply" else r.data_ptr(), packed.data_ptr(),
        out.data_ptr(), X, Y, Z, T, n, diag_tap, _taps_bytes(offsets[:n]),
        float(omega), torch.cuda.current_stream(x.device).cuda_stream)
    sc._raise_on(err, lib, "k3", f"K3 {mode}")
    name = "apply_prefix" if mode == "apply" and n < T else mode
    name = f"k3_{name}_{sc._DTYPES[x.dtype]}"
    sc._count(name, (X, Y, Z))
    return out
