"""Solver warm-up, the GPU form (counterpart of
``openimpala_tpu/solve/warmup.py``): overlap the kernels' build and load
with the host's work before the solve.

In the JAX package the thread compiles and loads the solve's programs from
shapes alone while the volume is read and the percolation fill runs.  On
the card the programs are the hand-written kernels (``csrc/*.cu``): their
first use compiles each source with ``nvcc`` (seconds per source on a
machine without the build cache; ``ops/stencil_cuda.py::build``) and loads
it.  Nothing of that depends on the volume, its direction or the dtypes,
only on the preconditioner, so a thread started at reader-metadata time
(the CLI) or before the percolation fill (``tortuosity``) builds and loads
the kernels the solve will launch, and launches each once at a small shape
on a side stream (uncounted: ``stencil_cuda.uncounted``):

    gmg (the default)  K1, K2
    sa                 K1, K3
    mg, jacobi, none   K1
    cheby              K1, K4, K5

(K1 always: the PCG's matvec and the float64 outer residual.)  The cell
problems of ``effective_diffusivity`` take the same rule.  No thread starts
once every one of these kernels is loaded in the process.  The CUDA graphs
of the solve are not primed here: a graph is captured on the solve's own
buffers (``utils/graphs.py``).

Where the port differs from the JAX package:
- its thread keeps its exception and ``join()`` raises it, so a failed
  build never gives way quietly to a build on demand (the JAX thread
  swallows every exception);
- the percolation fill and the system build need no priming, so
  ``wait_fill`` and ``wait_build`` return at once, and ``join()`` waits for
  the thread's end: no capture ever overlaps its launches;
- no size rule (the JAX package starts no thread below 192^3): the build
  is the same fixed cost at every size, paid by a process's first solve,
  so the overlap never costs more than the build on demand.
"""

from __future__ import annotations

import threading
import time

import torch

from ..utils import profiling


def warm_kernels(precond) -> tuple:
    """The kernels (``stencil_cuda.SOURCES`` names) a solve with
    ``precond`` launches (module docstring)."""
    resolved = "gmg" if precond in ("auto", None) else precond
    if not isinstance(resolved, str):  # a built preconditioner
        return ("k1",)
    extra = {"gmg": ("k2",), "sa": ("k3",), "samg": ("k3",),
             "cheby": ("k4", "k5"), "chebyshev": ("k4", "k5")}
    return ("k1",) + extra.get(resolved, ())


def _launch_once(name: str, dev):
    """One launch of kernel ``name`` at a small shape on the current
    stream (loads the library and makes the first launch)."""
    from ..ops import offset_cuda, stencil_cuda as sc

    shape, w, per = (8, 8, 8), (1.0, 1.0, 1.0), (False, False, False)
    x = torch.ones(shape, dtype=torch.float32, device=dev)
    if name == "k1":
        code = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        sc.k1_stencil("matvec", x, None, code, w, per, with_dot=True)
        sc.k1_stencil("matvec", x.double(), None, code, w, per)
    elif name == "k2":
        sc.k2_conductance("matvec", x, None, x, x, x, x)
        res, d, y = sc.k2_cheby_init(x, x, 1.0)
        sc.k2_cheby(d, res, y, x, x, x, x, 1.0, 1.0)
    elif name == "k3":
        offset_cuda.k3_offset("apply", x, None, x.reshape(8, 1, 8, 8),
                              ((0, 0, 0),))
    elif name == "k4":
        sc.k4_matvec(x, x, x > 0, w, per, with_dot=True)
    elif name == "k5":
        sc.k5_matvec_stream(x, x, x > 0, w, per)


def _warm(names, dev, timing: dict):
    """The thread's work: build and load ``names``, then launch each once
    on a side stream; the seconds of each stage go to ``timing``."""
    from ..ops import stencil_cuda as sc

    t0 = time.perf_counter()
    todo = tuple(n for n in names if n not in sc._libs)
    if todo:
        sc.build(todo)
    t1 = time.perf_counter()
    for n in names:
        sc._load(n)
    t2 = time.perf_counter()
    side = torch.cuda.Stream(dev)
    with sc.uncounted(), torch.cuda.device(dev), torch.cuda.stream(side):
        for n in names:
            _launch_once(n, dev)
    side.synchronize()
    timing.update(built=list(todo), build_s=t1 - t0, load_s=t2 - t1,
                  launch_s=time.perf_counter() - t2)


class SolverWarmup:
    """The background build and load of ``kernels`` on ``device``.
    ``timing`` holds the kernels, the thread's ``build_s``, ``load_s`` and
    ``launch_s``, and ``join_s``, the seconds ``join`` waited."""

    def __init__(self, kernels, device):
        self.timing = {"kernels": list(kernels), "join_s": 0.0}
        self.error = None
        self._thread = threading.Thread(
            target=self._run, args=(tuple(kernels), device), daemon=True,
            name="oi-solver-warmup")
        self._thread.start()

    def _run(self, kernels, device):
        try:
            with profiling.root("warmup"):
                _warm(kernels, device, self.timing)
        except BaseException as e:  # kept for join()
            self.error = e

    def wait_fill(self, direction=None, timeout: float = 600.0):
        """The JAX package's wait before a direction's percolation fill:
        returns at once (the port's fill needs no priming)."""

    def wait_build(self, direction=None, timeout: float = 600.0):
        """The JAX package's wait before a direction's system build:
        returns at once (the port's build needs no priming)."""

    def join(self, timeout: float = 600.0):
        """Wait for the thread's end, then raise its exception if it
        raised one.  Call it before the solve's first kernel."""
        t0 = time.perf_counter()
        self._thread.join(timeout)
        self.timing["join_s"] += time.perf_counter() - t0
        if self._thread.is_alive():
            raise TimeoutError(f"solver warm-up still running after "
                               f"{timeout:.0f} s")
        if self.error is not None:
            raise RuntimeError("solver warm-up failed: "
                               f"{self.error!r}") from self.error


def maybe_start(precond, device=None) -> SolverWarmup | None:
    """Start the warm-up thread for a solve with ``precond`` where it can
    pay: a CUDA ``device`` (None means CUDA) on a machine with a card
    (None elsewhere, as the JAX package returns None off the TPU), while
    one of the solve's kernels is not loaded yet in this process."""
    from ..ops import stencil_cuda as sc

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    kernels = warm_kernels(precond)
    if all(n in sc._libs for n in kernels):
        return None
    return SolverWarmup(kernels, dev)
