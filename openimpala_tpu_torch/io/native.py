"""ctypes binding to the native C++ runtime (counterpart of
``openimpala_tpu/io/native.py``): the percolation BFS, the seeded BFS of
the sharded fill, the threshold decoder, the bit unpacker and the remspot
filter.  Not bound: ``pack_eq`` (the port uploads the raw phase and
compares on the card).

The library is the repo's ``native/impala_native.cpp``, compiled by this
module with ``g++`` and the flags of ``native/Makefile`` on first use into
``openimpala_tpu_torch/_build/`` (never into ``native/``), under a name that
carries a hash of the source, the flags and the CPU that ``-march=native``
resolves to, so that a library built for another CPU is never loaded.
Where the compiler has no OpenMP runtime (``-fopenmp`` fails), the same
flags without it: OpenMP parallelises only the decoders of the file, not
the BFS and the filter this module binds.
Nothing is compiled at import time.  Where the library cannot be built or
loaded, ``get_lib()`` returns None and ``require_lib()`` raises with the
reason: the port's ``percolation_mask(method="native")`` never falls back
to another method quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "impala_native.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile, line 2
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall")
# the flags tried in turn: the Makefile's, then the same without OpenMP
FLAG_SETS = (CXXFLAGS, tuple(f for f in CXXFLAGS if f != "-fopenmp"))

_lock = threading.Lock()
_lib = None
_error = None  # why the library is unavailable, once a load was tried


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def _target_cpu() -> str:
    """The CPU that ``-march=native`` resolves to on this machine."""
    try:
        out = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    for line in out.stdout.splitlines():
        parts = line.split()
        if parts and parts[0] == "-march=" and len(parts) > 1:
            return parts[1]
    return "unknown"


def lib_path(flags=CXXFLAGS) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_cxx(),) + tuple(flags)).encode())
    h.update(_target_cpu().encode())
    return BUILD_DIR / f"libimpala_native_{h.hexdigest()[:16]}.so"


def _compile(flags) -> Path:
    """Compile with ``flags`` unless that library exists; raises with the
    compiler's output on failure."""
    out = lib_path(flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *flags, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"cannot run {cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half
    return out


def _build() -> Path:
    """The library of the first flag set that compiles (one that was
    built before is taken as it is)."""
    from ..utils.common import build_lock

    with build_lock(BUILD_DIR):  # the ranks of a sharded run build once
        for flags in FLAG_SETS:
            if lib_path(flags).exists():
                return lib_path(flags)
        errors = []
        for flags in FLAG_SETS:
            try:
                return _compile(flags)
            except RuntimeError as e:
                errors.append(str(e))
        raise RuntimeError("\n".join(errors))


def get_lib():
    """The loaded library, or None where it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        lib.impala_percolation_mask.restype = ctypes.c_int64
        lib.impala_percolation_mask_phase.restype = ctypes.c_int64
        lib.impala_threshold_decode.restype = ctypes.c_int
        lib.impala_unpack_bits.restype = ctypes.c_int
        lib.impala_remspot.restype = ctypes.c_int64
        lib.impala_bfs_seeded.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    return get_lib() is not None


def require_lib():
    """The loaded library; raises RuntimeError where it is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: {_error}")
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def percolation_mask(phase_ok: np.ndarray, direction: int):
    """(active bool, n_active) from a 0/1 mask of the phase (BFS from the
    inlet face, then from the outlet face inside the inlet-reachable set).
    Raises where the library is unavailable."""
    lib = require_lib()
    p = np.ascontiguousarray(phase_ok, np.int8)
    active = np.empty(p.shape, np.int8)
    n = lib.impala_percolation_mask(
        _ptr(p, ctypes.c_int8), ctypes.c_int64(p.shape[0]),
        ctypes.c_int64(p.shape[1]), ctypes.c_int64(p.shape[2]),
        ctypes.c_int(direction), _ptr(active, ctypes.c_int8),
    )
    if n < 0:
        raise MemoryError("native percolation: allocation failed")
    return active.view(bool), int(n)  # the C side writes 0 or 1


# the volume dtypes whose ``phase == phase_id`` comparison the C side fuses
# into its pad copy (impala_native.cpp make_padded_phase): 0 int8, 1 int32
_PHASE_DTYPES = {np.dtype(np.int8): 0, np.dtype(np.uint8): 0,
                 np.dtype(np.int32): 1}


def _reinterpret_phase_id(dtype, phase_id: int) -> int:
    """uint8 volumes ride the int8 C comparison: the volume bytes and the id
    pass through the same cast, so an id in [128, 255] maps to its int8
    reinterpretation (id - 256) and the comparison stays exact.  Ids outside
    [0, 255] never match a uint8 volume and are left as they are (the range
    guard then sends them to the compare-then-mask route)."""
    if np.dtype(dtype) == np.uint8 and 128 <= phase_id <= 255:
        return phase_id - 256
    return phase_id


def percolation_mask_phase(phase: np.ndarray, phase_id: int, direction: int):
    """Like ``percolation_mask`` but from the raw phase volume, the
    comparison fused into the C pad copy.  None where the volume's dtype or
    layout is outside that fast path (the caller then compares and calls
    ``percolation_mask``); raises where the library is unavailable."""
    lib = require_lib()
    phase = np.asarray(phase)
    code = _PHASE_DTYPES.get(phase.dtype)
    if code is None or not phase.flags.c_contiguous:
        return None
    phase_id = _reinterpret_phase_id(phase.dtype, phase_id)
    if code == 0 and not (-128 <= phase_id < 128):
        # the C side casts the id to int8: an out-of-range id would wrap
        # and falsely match
        return None
    active = np.empty(phase.shape, np.int8)
    n = lib.impala_percolation_mask_phase(
        phase.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(code),
        ctypes.c_int64(int(phase_id)), ctypes.c_int64(phase.shape[0]),
        ctypes.c_int64(phase.shape[1]), ctypes.c_int64(phase.shape[2]),
        ctypes.c_int(direction), _ptr(active, ctypes.c_int8),
    )
    if n < 0:
        raise MemoryError("native percolation: allocation failed")
    return active.view(bool), int(n)  # the C side writes 0 or 1


# dtype codes of impala_native.cpp's pick_loader
DTYPE_CODES = {
    "|u1": 0, "|i1": 1, "<i2": 2, ">i2": 3, "<u2": 4, ">u2": 5,
    "<i4": 6, ">i4": 7, "<u4": 8, ">u4": 9, "<f4": 10, ">f4": 11,
    "<f8": 12, ">f8": 13,
}


def threshold_decode(raw: np.ndarray, thr: float, vtrue: int, vfalse: int):
    """int8 ``raw > thr ? vtrue : vfalse`` of a buffer in any dtype of
    ``DTYPE_CODES`` (either byte order), or None for another dtype.
    Raises where the library is unavailable."""
    lib = require_lib()
    code = DTYPE_CODES.get(raw.dtype.str)
    if code is None:
        return None
    flat = np.ascontiguousarray(raw).reshape(-1)
    out = np.empty(flat.shape, np.int8)
    rc = lib.impala_threshold_decode(
        _ptr(flat.view(np.uint8), ctypes.c_uint8), ctypes.c_int64(flat.size),
        ctypes.c_int(code), ctypes.c_double(thr), ctypes.c_int8(vtrue),
        ctypes.c_int8(vfalse), _ptr(out, ctypes.c_int8),
    )
    if rc != 0:
        raise RuntimeError(f"native threshold_decode failed ({rc})")
    return out.reshape(raw.shape)


def unpack_bits(packed: np.ndarray, n_values: int, fill_order: int = 1):
    """``n_values`` bits of ``packed`` as 0/1 uint8, MSB first
    (``fill_order=1``) or LSB first (2).  Raises where the library is
    unavailable."""
    lib = require_lib()
    packed = np.ascontiguousarray(packed, np.uint8)
    out = np.empty(n_values, np.uint8)
    lib.impala_unpack_bits(_ptr(packed, ctypes.c_uint8),
                           ctypes.c_int64(n_values), ctypes.c_int(fill_order),
                           _ptr(out, ctypes.c_uint8))
    return out


def remspot(phase: np.ndarray):
    """(filtered int32 phase, number of flipped cells): one pass of the
    reference's remspot filter.  Raises where the library is
    unavailable."""
    lib = require_lib()
    p = np.ascontiguousarray(phase, np.int32)
    out = np.empty(p.shape, np.int32)
    flips = lib.impala_remspot(
        _ptr(p, ctypes.c_int32), ctypes.c_int64(p.shape[0]),
        ctypes.c_int64(p.shape[1]), ctypes.c_int64(p.shape[2]),
        _ptr(out, ctypes.c_int32),
    )
    return out, int(flips)


def bfs_seeded(phase_ok: np.ndarray, prev_mask: np.ndarray,
               seeds: np.ndarray):
    """Incremental seeded BFS, the per-slab step of the sharded
    percolation (``ops/floodfill.py::percolation_mask_sharded``): expands
    the ``seeds`` that are open (``phase_ok``) and not yet in
    ``prev_mask`` over ``phase_ok``.  Returns ``(mask_out, n_new)`` with
    ``mask_out = prev_mask | newly reached`` (bool) and the count of newly
    reached cells.  Raises where the library is unavailable."""
    lib = require_lib()
    p = np.ascontiguousarray(phase_ok, np.int8)
    m = np.ascontiguousarray(prev_mask, np.int8)
    s = np.ascontiguousarray(seeds, np.int8)
    out = np.empty(p.shape, np.int8)
    n = lib.impala_bfs_seeded(
        _ptr(p, ctypes.c_int8), _ptr(m, ctypes.c_int8),
        _ptr(s, ctypes.c_int8), ctypes.c_int64(p.shape[0]),
        ctypes.c_int64(p.shape[1]), ctypes.c_int64(p.shape[2]),
        _ptr(out, ctypes.c_int8),
    )
    if n < 0:
        raise MemoryError("native seeded BFS: allocation failed")
    return out.view(bool), int(n)
