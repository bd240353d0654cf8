"""The hand-written CUDA kernels of the stencil path: build, load, launch
(K1, K2, K4 and K5 here; K3's launcher is ``ops/offset_cuda.py``, on this
module's build, loader, checks and counters).

K1 (``csrc/k1_stencil.cu``) replaces
``openimpala_tpu/ops/stencil_pallas.py::fused_stencil_pallas`` (body
``_fused_kernel_v3``): the masked 7-point operator decoded from the packed
bf16 geometry, in modes matvec (optionally with the fused <x, Ax>), resid,
sweep and restrict; float32 and float64.

K2 (``csrc/k2_conductance.cu``) replaces
``openimpala_tpu/ops/stencil_pallas.py::fused_conductance_pallas`` (body
``_cond_kernel``): the face-conductance operator of the Galerkin coarse
levels, in modes matvec and sweep; float32 and float64.  Its cheby and
cheby_init modes (``k2_cheby``, ``k2_cheby_init``) replace no Pallas
kernel: each is one step of the Chebyshev iteration on D^-1 A
(``GalerkinMGPreconditioner._smooth_cheby``'s loop body, the operator and
the vector updates) in one launch, equal to that body's separate
roundings.

K4 (``csrc/k4_matvec.cu``) replaces
``openimpala_tpu/ops/stencil_pallas.py::stencil_matvec_pallas`` (body
``_matvec_kernel``): the masked 7-point operator from explicit (diag, free)
arrays, diag a scalar, one scalar per lane or a full array, over an
optional batch of volumes (each lane wraps on its own), with the optional
fused <x, Ax> per lane; float32 and float64.

K5 (``csrc/k5_matvec_stream.cu``) replaces
``openimpala_tpu/ops/stencil_pallas.py::stencil_matvec_pallas_v2`` (body
``_matvec_kernel_v2``): the same function with a full-array diag, no dot
and no batch, as one streaming pass down X with the current plane's tile
in shared memory; float32 and float64.

Bound on an H100: all four are memory-bound stencils (about 1 flop per byte,
far below the card's ~20 flop/byte f32 balance).  Compulsory traffic per
cell, each input read once and each output written once:

    K1 matvec (x, code, out)            10 B f32   18 B f64
    K1 resid / sweep (x, r, code, out)  14 B f32   26 B f64
    K1 restrict (x, r, code, out/8)     10.5 B f32
    K2 matvec (x, cx, cy, cz, diag, out) 24 B f32
    K2 sweep (adds r)                   28 B f32
    K2 cheby (d, cx, cy, cz, diag, res, x; res, d_new, x)
                                        40 B f32   80 B f64
    K2 cheby_init (r, diag; res, d, x)  20 B f32   40 B f64
    K4 / K5 (x, diag, free, out)        13 B f32   25 B f64
    K4 with a scalar or per-lane diag    9 B f32   17 B f64

K1 has two routes, chosen from the shape alone (``k1_route``).  The
*stream* route takes every volume whose rows are whole 16-byte vectors and
at least one tile wide (Z a multiple of 4 and >= 128 in float32, of 2 and
>= 64 in float64) and large enough to give each multiprocessor a block: a
block owns a 16 x 128-cell tile of the (Y, Z) plane (16 x 64 in float64;
8 rows where Y or Z is periodic) and streams down a run of 64 X planes
(``k1_plan``; 32 where a small volume needs more blocks), so the X halo is
3 %; x reaches shared memory through the Tensor Memory Accelerator into a
ring of four planes with an mbarrier pair per stage and no block-wide
barrier per plane; a thread owns one 16-byte vector of two rows (one),
loads r and code once with streaming 16- and 8-byte loads one plane ahead,
stores out with a streaming 16-byte store, and restrict sums its 2x2x2 in
the same pass.  What that moves beyond the compulsory bytes: the tile's
halo, (16+2)/16 x (128+8)/128 = 1.195 of x (4 of the 10 to 14 bytes per
cell), read through L2, and 2 planes per run.  The *general* route takes
every other extent down to 1 with one thread per cell (Y and Z neighbours
through L1/L2, 4-byte loads, restrict recomputing 8 stencils per coarse
cell).  K2, K4 and K5 keep that simple design; the fused dots pay a second
one-block launch.

Build: each source is compiled by its own ``nvcc`` into a plain-C shared
library (``-gencode arch=compute_90a,code=sm_90a``), all started together,
on first use, into ``openimpala_tpu_torch/_build/`` under a name that
carries a hash of the sources and flags, with the compiler's output
(ptxas's register and spill report) beside it as ``.log``; the libraries
are loaded with ctypes.  Nothing is compiled or loaded at import time.

Counters: every launch adds one to ``launches[name]``
(``k1_<mode>[_dot]_<f32|f64>``, ``k2_<mode>_<f32|f64>`` (``k2_cheby``,
``k2_cheby_init`` among the modes),
``k3_<mode>_<f32|f64>``, ``k3_apply_prefix_<f32|f64>``,
``k4_matvec[_dot]_<f32|f64>``, ``k5_matvec_<f32|f64>``), and every call of
a plain form with a CUDA tensor adds one to ``plain_on_cuda[name]``.
K2, K3 and K4 run on the levels of a hierarchy or on batches, and K5 on a
whole volume or on a padded X slab, so their launchers also add one to
``launches_at[(name, extent)]``: the same launches, split by extent
(``(X, Y, Z)``; ``(B, X, Y, Z)`` for a batch of K4).
K1's launcher adds one to ``launches_route[(name, route)]`` and to
``launches_route_at[(name, route, (X, Y, Z))]``: the same launches, split
by the route that served them.

A CUDA graph replays its kernels without running any of this Python, so
``utils/graphs.py`` takes the counts a capture made (``snapshot_counts``,
``counts_since``), puts the counters back as they were before it
(``restore_counts``: a capture runs nothing), and adds the captured counts
once per replay (``add_counts``).  Launches made inside ``uncounted()`` on
the calling thread (the solver warm-up's, ``solve/warmup.py``) add to no
counter.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"k1": "k1_stencil.cu", "k2": "k2_conductance.cu",
           "k3": "k3_offset.cu", "k4": "k4_matvec.cu",
           "k5": "k5_matvec_stream.cu"}
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

K1_MODES = {"matvec": 0, "resid": 1, "sweep": 2, "restrict": 3}
K2_MODES = {"matvec": 0, "sweep": 1}
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y and gridDim.z

launches: collections.Counter = collections.Counter()
launches_at: collections.Counter = collections.Counter()  # (name, shape)
launches_route: collections.Counter = collections.Counter()  # (name, route)
# (name, route, shape)
launches_route_at: collections.Counter = collections.Counter()
plain_on_cuda: collections.Counter = collections.Counter()
COUNTERS = {"launches": launches, "launches_at": launches_at,
            "launches_route": launches_route,
            "launches_route_at": launches_route_at,
            "plain_on_cuda": plain_on_cuda}

_lock = threading.Lock()
_libs: dict = {}
_local = threading.local()  # .uncounted: this thread's launches count not


def reset_counts():
    for c in COUNTERS.values():
        c.clear()


def snapshot_counts() -> dict:
    """A copy of every counter."""
    return {k: collections.Counter(c) for k, c in COUNTERS.items()}


def counts_since(before: dict) -> dict:
    """What each counter gained since ``before`` (``snapshot_counts``)."""
    return {k: c - before[k] for k, c in COUNTERS.items()}


def restore_counts(before: dict):
    """Put every counter back to ``before``."""
    for k, c in COUNTERS.items():
        c.clear()
        c.update(before[k])


def add_counts(deltas: dict):
    """Add ``deltas`` (``counts_since``) to the counters."""
    for k, c in COUNTERS.items():
        c.update(deltas[k])


@contextlib.contextmanager
def uncounted():
    """Launches made in the block by this thread add to no counter."""
    prev = getattr(_local, "uncounted", False)
    _local.uncounted = True
    try:
        yield
    finally:
        _local.uncounted = prev


def _count(name: str, shape=None, route=None):
    """One launch of ``name``; ``route``: K1's; ``shape`` with no route:
    the extent K2 to K5 ran at."""
    if getattr(_local, "uncounted", False):
        return
    launches[name] += 1
    if route is not None:
        launches_route[name, route] += 1
        launches_route_at[name, route, shape] += 1
    elif shape is not None:
        launches_at[name, shape] += 1


def note_plain(name: str, x: torch.Tensor):
    """Count a call of a plain form with a CUDA tensor."""
    if x.is_cuda:
        plain_on_cuda[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], *_HEADERS):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the named kernels (one ``nvcc`` each, run in parallel) unless
    an up-to-date library exists.  Returns ``{name: (path, compiler
    output)}``; the output (with ptxas's register and spill report) is kept
    beside the library as ``<library>.log``.  Raises with the compiler
    output on failure."""
    from ..utils.common import build_lock

    with build_lock(BUILD_DIR):  # the ranks of a sharded run build once
        return _build(names)


def _build(names) -> dict:
    jobs, result = [], {}
    for name in names:
        out = _lib_path(name)
        log_path = out.with_suffix(".log")
        if out.exists() and log_path.exists():
            result[name] = (out, log_path.read_text())
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        # atomic: a concurrent builder never loads a half-written file, and
        # the log lands first, so a library that exists has its log
        log_tmp = tmp.with_suffix(".log")
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(tmp, out)
        result[name] = (out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


def _load(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path, _ = build((name,))[name]
        lib = ctypes.CDLL(str(path))
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
            ctypes.c_double
        if name == "k1":
            for fn in (lib.k1_launch_f32, lib.k1_launch_f64):
                fn.argtypes = [i, i, p, p, p, p, p, p, ll, ll, ll, i, i, i, i,
                               d, d, d, d, p]
                fn.restype = i
            lib.k1_num_partials.argtypes = [ll, ll, ll]
            lib.k1_num_partials.restype = ll
            lib.k1_launch_stream.argtypes = [i, i, i, i, p, p, p, p, p, p, ll,
                                             p, ll, ll, ll, i, i, i, i, d, d,
                                             d, d, ll, p]
            lib.k1_launch_stream.restype = i
            lib.k1_encode_map.argtypes = [p, i, i, p, ll, ll, ll]
            lib.k1_encode_map.restype = i
        elif name == "k2":
            for fn in (lib.k2_launch_f32, lib.k2_launch_f64):
                fn.argtypes = [i, p, p, p, p, p, p, p, ll, ll, ll, d, p]
                fn.restype = i
            for fn in (lib.k2_cheby_f32, lib.k2_cheby_f64):
                fn.argtypes = [i, p, p, p, p, p, p, p, p, ll, ll, ll, d, d, p]
                fn.restype = i
        elif name == "k3":
            lib.k3_launch.argtypes = [i, i, i, p, p, p, p, ll, ll, ll, i, i,
                                      i, ctypes.c_char_p, d, p]
            lib.k3_launch.restype = i
        elif name == "k4":
            lib.k4_launch.argtypes = [i, i, i, p, p, p, p, p, p, ll, ll, ll,
                                      ll, i, i, i, d, d, d, p]
            lib.k4_launch.restype = i
            lib.k4_num_partials.argtypes = [ll, ll, ll, ll]
            lib.k4_num_partials.restype = ll
        else:
            lib.k5_launch.argtypes = [i, p, p, p, p, ll, ll, ll, i, i, i, d,
                                      d, d, p]
            lib.k5_launch.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def _check(t, what: str, like=None, dtype=None, ndim=(3,)):
    if t is None:
        raise ValueError(f"{what} is required")
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor (got {t.device})")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what} is on {t.device}, not the current device")
    if t.dim() not in ndim:
        raise ValueError(f"{what} must be {' or '.join(map(str, ndim))}-D "
                         f"(got shape {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype} (got {t.dtype})")
    if like is not None and t.shape != like.shape:
        raise ValueError(f"{what} shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{what} is on {t.device}, x on {like.device}")


def _check_x(x, kernel: str, ndim=(3,)):
    _check(x, "x", ndim=ndim)
    if x.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: x must be float32 or float64 "
                         f"(got {x.dtype})")
    X, Y, Z = x.shape[-3:]
    if min(x.shape) < 1:
        raise ValueError(f"{kernel}: empty volume {tuple(x.shape)}")
    lanes = x.shape[0] if x.dim() == 4 else 1
    # K4 carries the batch in gridDim.z beside the X runs of 8 planes
    if (-(-Y // 8) > _GRID_YZ_MAX or X > _GRID_YZ_MAX
            or lanes * -(-X // 8) > _GRID_YZ_MAX):
        raise ValueError(f"{kernel}: extent {tuple(x.shape)} exceeds the grid")


def _raise_on(err: int, lib, name: str, what: str):
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# K1: the route, the plan of a launch and its cost, all from the shape
# ---------------------------------------------------------------------------

K1_ROUTES = ("stream", "general")
K1_WARPS = 8  # consumer warps of a stream block (csrc NW), plus one producer
K1_STAGES = 4  # planes in the shared-memory ring (csrc K1_STAGES)
K1_RUN = 64  # X planes a stream block walks: the X halo is 2 in 64
K1_MIN_RUN = 32  # ... and the fewest, where a small volume needs more blocks
K1_FILL_BLOCKS = 264  # blocks wanted before runs stop shrinking: 2 x 132 SMs
K1_MIN_BLOCKS = 132  # fewer than one block per SM: the general route
SMEM_BLOCK_MAX = 232448  # bytes of shared memory one block can use (sm_90)
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
# flops per cell, as the kernels' expressions count them
_K1_FLOPS = {"matvec": 10, "matvec_dot": 12, "resid": 11, "sweep": 14,
             "restrict": 12}


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """One K1 launch: the route, the grid (x, y, z), the threads and the
    dynamic shared memory of a block, the (Y, Z) tile of a block and the X
    planes it walks, and (stream route) the rows per consumer thread."""

    route: str
    grid: tuple
    threads: int
    smem: int
    tile: tuple
    run: int
    rows: int

    @property
    def blocks(self) -> int:
        return math.prod(self.grid)


def _stream_run(X: int, tiles: int) -> int:
    """X planes per stream block: runs of about K1_RUN planes; shorter,
    down to K1_MIN_RUN, where the grid would otherwise not fill the card;
    even, so that a restrict block holds whole plane pairs."""
    nruns = max(1, X // K1_RUN)
    if tiles * nruns < K1_FILL_BLOCKS:
        nruns = max(nruns, min(-(-K1_FILL_BLOCKS // tiles), X // K1_MIN_RUN))
    run = -(-X // nruns)
    return run + (run & 1)


def _stream_plan(mode, shape, dtype, periodic, run=None, rows=None) -> K1Plan:
    """The stream route's launch.  A thread owns two rows of a tile, which
    restrict needs and which is 3 to 5 % faster on clamped volumes; with a
    seam along Y or Z (a periodic axis) it owns one: the seam cells come
    from global memory inside the plane loop, and the two-row kernel, at
    two blocks per multiprocessor, has too few warps to hide that (5 to
    15 % slower there)."""
    X, Y, Z = shape
    es = _ITEMSIZE[dtype]
    vec = 16 // es
    if rows is None:
        rows = 2 if mode == "restrict" or not (periodic[1] or periodic[2]) \
            else 1
    if rows not in (1, 2) or (mode == "restrict" and rows != 2):
        raise ValueError(f"K1: rows={rows} for mode {mode!r}")
    ty, tz = K1_WARPS * rows, 32 * vec
    tiles = -(-Z // tz) * -(-Y // ty)
    run = run or _stream_run(X, tiles)
    if run < 1 or (mode == "restrict" and run % 2):
        raise ValueError(f"K1: run={run} for mode {mode!r}")
    stage = -(-((ty + 2) * (tz + 2 * vec) * es) // 128) * 128
    grid = (-(-Z // tz), -(-Y // ty), -(-X // run))
    return K1Plan("stream", grid, (K1_WARPS + 1) * 32,
                  K1_STAGES * stage + 128, (ty, tz), run, rows)


def k1_stream_takes(shape, dtype, aligned: bool = True) -> bool:
    """Whether the stream route can serve the volume at all: a row of Z is
    whole 16-byte vectors (the tensor map's stride rule and the vector
    loads of ``r``, ``code`` and ``out``) and at least one tile of 32
    vectors wide, and every base address is 16-byte aligned."""
    vec = 16 // _ITEMSIZE[dtype]
    return bool(aligned and shape[2] % vec == 0 and shape[2] >= 32 * vec
                and min(shape) >= 1 and max(shape) < 2 ** 31)


def k1_route(shape, dtype, periodic=(False, False, False),
             aligned: bool = True) -> str:
    """The route that serves K1 on an (X, Y, Z) volume, a rule of the shape
    alone: ``"stream"`` where the stream route can take the volume
    (``k1_stream_takes``) and its grid gives every multiprocessor a block,
    ``"general"`` otherwise (small volumes, where everything sits in L2
    and a launch is mostly latency, and rows that are not whole vectors)."""
    if (k1_stream_takes(shape, dtype, aligned) and _stream_plan(
            "matvec", shape, dtype, periodic).blocks >= K1_MIN_BLOCKS):
        return "stream"
    return "general"


def k1_plan(mode: str, shape, dtype, periodic=(False, False, False),
            aligned: bool = True, route=None, run=None, rows=None) -> K1Plan:
    """Plan one K1 launch (``mode`` may be ``"matvec_dot"``).  ``route``,
    ``run`` and ``rows`` override the rule, for measurements and seam
    tests; a route the shape cannot take raises."""
    X, Y, Z = shape
    route = route or k1_route(shape, dtype, periodic, aligned)
    if route not in K1_ROUTES:
        raise ValueError(f"unknown K1 route {route!r}")
    if route == "stream":
        if not k1_stream_takes(shape, dtype, aligned):
            raise ValueError(f"K1: the stream route cannot take "
                             f"{tuple(shape)} {dtype} (aligned={aligned})")
        plan = _stream_plan(mode, shape, dtype, periodic, run, rows)
    elif mode == "restrict":
        plan = K1Plan(route, (-(-(Z // 2) // 32), -(-(Y // 2) // 8), X // 2),
                      256, 0, (8, 32), 1, 1)
    else:
        plan = K1Plan(route, (-(-Z // 32), -(-Y // 8), -(-X // 8)), 256,
                      2048 if mode == "matvec_dot" else 0, (8, 32), 8, 1)
    if (plan.grid[1] > _GRID_YZ_MAX or plan.grid[2] > _GRID_YZ_MAX
            or plan.grid[0] >= 2 ** 31):
        raise ValueError(f"K1: extent {tuple(shape)} exceeds the grid")
    return plan


def k1_cost(mode: str, shape, dtype):
    """(compulsory bytes, flops) of one K1 launch: x, code and out (and r
    for resid, sweep, restrict), each read or written once; restrict
    writes an eighth of the cells.  ``mode`` may be ``"matvec_dot"``."""
    es = _ITEMSIZE[dtype]
    cells = math.prod(shape)
    per_cell = es + 2 + (es / 8 if mode == "restrict" else es)
    if mode not in ("matvec", "matvec_dot"):
        per_cell += es
    return per_cell * cells, _K1_FLOPS[mode] * cells


_k1_maps: dict = {}  # (x address, shape, dtype, rows) -> 128-byte tensor map


def _k1_map(lib, x, rows: int):
    """The tensor map of ``x`` for the stream route, encoded once per
    (address, shape, dtype, rows): the allocator hands the solver the same
    few blocks over and over."""
    key = (x.data_ptr(), tuple(x.shape), x.dtype, rows)
    buf = _k1_maps.get(key)
    if buf is None:
        if len(_k1_maps) >= 4096:
            _k1_maps.clear()
        buf = ctypes.create_string_buffer(128)
        err = lib.k1_encode_map(buf, int(x.dtype == torch.float64), rows,
                                x.data_ptr(), *x.shape)
        if err != 0:
            raise RuntimeError(
                "K1: cuTensorMapEncodeTiled "
                + ("is not in this CUDA library" if err < 0
                   else f"failed with CUresult {err}")
                + f" for x {tuple(x.shape)} {x.dtype}")
        _k1_maps[key] = buf
    return buf


def k1_stencil(mode: str, x, r, code, w, periodic, omega: float = 0.9,
               with_dot: bool = False, route=None, run=None, rows=None):
    """Launch K1 on the current stream.  ``x`` (and ``r`` for resid, sweep,
    restrict) float32/float64, ``code`` bfloat16, all contiguous (X, Y, Z)
    on the current CUDA device.  Returns ``out``, or ``(out, dot)`` with a
    0-d ``dot = <x, out>`` when ``with_dot`` (matvec only).  restrict needs
    every extent even and returns the (X/2, Y/2, Z/2) coarse residual.
    The route follows ``k1_route``; ``route``, ``run`` and ``rows`` override
    the plan (``k1_plan``) for measurements and seam tests."""
    if mode not in K1_MODES:
        raise ValueError(f"unknown K1 mode {mode!r}")
    if with_dot and mode != "matvec":
        raise ValueError("with_dot applies to mode 'matvec' only")
    _check_x(x, "K1")
    _check(code, "code", like=x, dtype=torch.bfloat16)
    if mode != "matvec":
        _check(r, "r", like=x, dtype=x.dtype)
    X, Y, Z = x.shape
    if mode == "restrict" and (X % 2 or Y % 2 or Z % 2):
        raise ValueError(f"K1 restrict needs even extents, got {(X, Y, Z)}")
    lib = _load("k1")
    oshape = (X // 2, Y // 2, Z // 2) if mode == "restrict" else (X, Y, Z)
    out = torch.empty(oshape, dtype=x.dtype, device=x.device)
    rp = None if r is None or mode == "matvec" else r.data_ptr()
    aligned = all(a % 16 == 0 for a in (x.data_ptr(), rp or 0,
                                        code.data_ptr(), out.data_ptr()))
    plan = k1_plan(f"{mode}_dot" if with_dot else mode, (X, Y, Z), x.dtype,
                   periodic, aligned, route, run, rows)
    partials = dot = None
    if with_dot:
        partials = torch.empty(plan.blocks, dtype=torch.float64,
                               device=x.device)
        dot = torch.empty((), dtype=x.dtype, device=x.device)
    pp = None if partials is None else partials.data_ptr()
    dp = None if dot is None else dot.data_ptr()
    geom = (X, Y, Z, int(bool(periodic[0])), int(bool(periodic[1])),
            int(bool(periodic[2])), int(not (w[0] == w[1] == w[2])),
            float(w[0]), float(w[1]), float(w[2]), float(omega))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "stream":
        err = lib.k1_launch_stream(
            int(x.dtype == torch.float64), plan.rows, K1_MODES[mode],
            int(with_dot), _k1_map(lib, x, plan.rows), x.data_ptr(), rp,
            code.data_ptr(), out.data_ptr(), pp, plan.blocks, dp, *geom,
            plan.run, stream)
    else:
        if with_dot and lib.k1_num_partials(X, Y, Z) != plan.blocks:
            raise RuntimeError("K1: the plan's grid is not the kernel's")
        fn = (lib.k1_launch_f32 if x.dtype == torch.float32
              else lib.k1_launch_f64)
        err = fn(K1_MODES[mode], int(with_dot), x.data_ptr(), rp,
                 code.data_ptr(), out.data_ptr(), pp, dp, *geom, stream)
    _raise_on(err, lib, "k1", f"K1 {mode} ({plan.route} route)")
    name = f"k1_{mode}{'_dot' if with_dot else ''}_{_DTYPES[x.dtype]}"
    _count(name, (X, Y, Z), plan.route)
    return (out, dot) if with_dot else out


def k2_conductance(mode: str, x, r, cx, cy, cz, diag, omega: float = 0.9):
    """Launch K2 on the current stream: ``x``, ``cx``, ``cy``, ``cz``,
    ``diag`` (and ``r`` for sweep) of one float dtype, contiguous (X, Y, Z)
    on the current CUDA device."""
    if mode not in K2_MODES:
        raise ValueError(f"unknown K2 mode {mode!r}")
    _check_x(x, "K2")
    for t, what in ((cx, "cx"), (cy, "cy"), (cz, "cz"), (diag, "diag")):
        _check(t, what, like=x, dtype=x.dtype)
    if mode == "sweep":
        _check(r, "r", like=x, dtype=x.dtype)
    X, Y, Z = x.shape
    lib = _load("k2")
    out = torch.empty_like(x)
    fn = lib.k2_launch_f32 if x.dtype == torch.float32 else lib.k2_launch_f64
    err = fn(K2_MODES[mode], x.data_ptr(),
             r.data_ptr() if mode == "sweep" else None,
             cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), diag.data_ptr(),
             out.data_ptr(), X, Y, Z, float(omega),
             torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "k2", f"K2 {mode}")
    _count(f"k2_{mode}_{_DTYPES[x.dtype]}", (X, Y, Z))
    return out


def k2_cheby_bound(init: bool, d, res, x, cx, cy, cz, diag, out):
    """K2's cheby (``init`` False) or cheby_init step on these buffers,
    checked and bound once: the returned ``launch(c1, c2)`` launches it
    on the current stream, as ``k2_cheby`` and ``k2_cheby_init`` do, for
    a loop that repeats the step on the same buffers."""
    _check_x(d, "K2")
    for t, what in ((res, "res"), (x, "x"), (cx, "cx"), (cy, "cy"),
                    (cz, "cz"), (diag, "diag"), (out, "out")):
        _check(t, what, like=d, dtype=d.dtype)
    # res and x are updated in place and out is written while the
    # neighbours of d are read: no two of them may share memory
    ptrs = [t.data_ptr() for t in (d, res, x, out)]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("K2 cheby: d, res, x and out must be distinct")
    X, Y, Z = d.shape
    lib = _load("k2")
    fn = lib.k2_cheby_f32 if d.dtype == torch.float32 else lib.k2_cheby_f64
    args = (int(init), d.data_ptr(), res.data_ptr(), x.data_ptr(),
            cx.data_ptr(), cy.data_ptr(), cz.data_ptr(), diag.data_ptr(),
            out.data_ptr(), X, Y, Z)
    mode = "cheby_init" if init else "cheby"
    name = f"k2_{mode}_{_DTYPES[d.dtype]}"
    device = d.device
    keep = (d, res, x, cx, cy, cz, diag, out)  # alive while bound

    def launch(c1: float, c2: float):
        err = fn(*args, float(c1), float(c2),
                 torch.cuda.current_stream(device).cuda_stream)
        _raise_on(err, lib, "k2", f"K2 {mode}")
        _count(name, (X, Y, Z))

    launch.buffers = keep
    return launch


def k2_cheby(d, res, x, cx, cy, cz, diag, c1: float, c2: float, out=None):
    """One Chebyshev step on the current stream (K2's cheby mode): ``res
    -= free ? A d : 0``, ``out = c1*d + c2*(inv_d*res)``, ``x += out``,
    with ``inv_d = diag > 0 ? 1/diag : 0``.  ``res`` and ``x`` are updated
    in place; ``out`` (new when None) must not be ``d``.  ``c1``, ``c2``:
    values of the working dtype.  Returns ``out``."""
    out = torch.empty_like(d) if out is None else out
    k2_cheby_bound(False, d, res, x, cx, cy, cz, diag, out)(c1, c2)
    return out


def k2_cheby_init(r, diag, c0: float):
    """The zero-start Chebyshev step on the current stream (K2's
    cheby_init mode): ``(res, d, x) = (r, (inv_d*r)*c0, 0 + d)`` in new
    tensors.  It reads no conductance (``r`` fills their unused slots)."""
    res, d, x = (torch.empty_like(r) for _ in range(3))
    k2_cheby_bound(True, r, res, x, r, r, r, diag, d)(c0, 0.0)
    return res, d, x


def _check_free(free, x, kernel: str):
    _check(free, "free", like=x, ndim=(3, 4))
    if free.dtype not in (torch.bool, torch.int8):
        raise ValueError(f"{kernel}: free must be bool or int8 "
                         f"(got {free.dtype})")


K4_DIAG_MODES = {"scalar": 0, "lane": 1, "full": 2}


def k4_matvec(x, diag, free, w, periodic, with_dot: bool = False):
    """Launch K4 on the current stream: ``free ? diag*x - sum_f w_f x_nbr :
    0``.  ``x`` float32/float64, contiguous (X, Y, Z) or (B, X, Y, Z) on the
    current CUDA device, each lane wrapping or clamping on its own; ``diag``
    of ``x``'s dtype: 0-d (one scalar), (B,) (one scalar per lane) or like
    ``x``; ``free`` bool or int8 like ``x``.  Returns ``out``, or ``(out,
    dot)`` when ``with_dot``, ``dot = <x, out>`` per lane: 0-d for a 3-D
    ``x``, (B,) for a batch, in ``x``'s dtype."""
    _check_x(x, "K4", ndim=(3, 4))
    _check_free(free, x, "K4")
    B = x.shape[0] if x.dim() == 4 else 1
    X, Y, Z = x.shape[-3:]
    if diag is None or not diag.is_cuda or diag.device != x.device:
        raise ValueError("K4: diag must be a CUDA tensor on x's device")
    if diag.dtype != x.dtype:
        raise ValueError(f"K4: diag must be {x.dtype} (got {diag.dtype})")
    if diag.dim() == 0:
        mode = "scalar"
    elif x.dim() == 4 and tuple(diag.shape) == (B,):
        mode = "lane"
    elif diag.shape == x.shape:
        mode = "full"
    else:
        raise ValueError(f"K4: diag shape {tuple(diag.shape)} is neither "
                         f"(), (B,) nor {tuple(x.shape)}")
    if not diag.is_contiguous():
        raise ValueError("K4: diag must be contiguous")
    lib = _load("k4")
    out = torch.empty_like(x)
    partials = dot = None
    if with_dot:
        partials = torch.empty(lib.k4_num_partials(B, X, Y, Z),
                               dtype=torch.float64, device=x.device)
        dot = torch.empty(x.shape[:-3], dtype=x.dtype, device=x.device)
    err = lib.k4_launch(
        int(x.dtype == torch.float64), K4_DIAG_MODES[mode], int(with_dot),
        x.data_ptr(), diag.data_ptr(), free.data_ptr(), out.data_ptr(),
        None if partials is None else partials.data_ptr(),
        None if dot is None else dot.data_ptr(), B, X, Y, Z,
        int(bool(periodic[0])), int(bool(periodic[1])),
        int(bool(periodic[2])), float(w[0]), float(w[1]), float(w[2]),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "k4", "K4 matvec")
    _count(f"k4_matvec{'_dot' if with_dot else ''}_{_DTYPES[x.dtype]}",
           tuple(x.shape))
    return (out, dot) if with_dot else out


def k5_matvec_stream(x, diag, free, w, periodic):
    """Launch K5 on the current stream: the function of K4 as one streaming
    pass down X.  ``x`` float32/float64, contiguous (X, Y, Z) on the
    current CUDA device; ``diag`` like ``x``, ``free`` bool or int8 like
    ``x``.  Returns ``out``."""
    _check_x(x, "K5")
    _check(diag, "diag", like=x, dtype=x.dtype)
    _check_free(free, x, "K5")
    X, Y, Z = x.shape
    lib = _load("k5")
    out = torch.empty_like(x)
    err = lib.k5_launch(
        int(x.dtype == torch.float64), x.data_ptr(), diag.data_ptr(),
        free.data_ptr(), out.data_ptr(), X, Y, Z, int(bool(periodic[0])),
        int(bool(periodic[1])), int(bool(periodic[2])), float(w[0]),
        float(w[1]), float(w[2]),
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "k5", "K5 matvec")
    _count(f"k5_matvec_{_DTYPES[x.dtype]}", (X, Y, Z))
    return out
