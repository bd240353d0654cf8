"""CUDA graphs for the solvers' chunks: the port's counterpart of the JAX
package's ``jax.jit`` on a chunk (``solve/cg.py::_cg_chunk``,
``solve/lanes.py::_cg_chunk_lanes``, ``solve/batched.py::
_batched_cg_chunk``, the loop of ``props/tortuosity_direct.py``).

A solver's chunk is ``reps`` repetitions of one ``step`` (one PCG
iteration; one check interval of ``tortuosity_direct``), then a ``tail``
that packs the probe the host reads.  A ``ChunkGraph`` holds the two on
CUDA.  Their inputs (the solver state, then constants such as ``denom``
and ``eps`` as tensors) live in static buffers: ``load`` copies a round's
start into them.  The step updates the state buffers in place and returns
nothing; the tail returns its outputs, which land in its graph's private
pool.  Each of the two runs eagerly once (the warm-up that capture needs:
libraries loaded, K1's shared-memory attribute set), is captured into a
``torch.cuda.CUDAGraph`` right after, while the card still runs that
eager call, and is replayed from then on.  So a solve's first chunk is one
eager step and ``reps - 1`` replays, and every later chunk is replays
only.  A body may read no device value on the host; a capture that fails
raises.

Why a step and not the whole chunk: a capture costs the host about the
body's enqueue time plus the instantiation, and the card waits meanwhile.
An eager chunk whose host time matches its device time (the default
cycle at 512^3) already hides its host, so capturing 16 iterations made
such solves 0.1 to 1.2 s slower; a step's capture costs a sixteenth of
that, and its in-place update needs no copy of the state.

Replays run no Python, so the kernels' launch counters
(``ops/stencil_cuda.py``) would stop counting: a capture records the
counts its Python made, puts the counters back (a capture runs nothing),
and each replay adds the recorded counts once.

Everything a body takes from Python is frozen into the graph at capture:
the kernels' routes and plans, K1's tensor maps (keyed by address) and
every Python scalar.  So a graph must only ever see its own static
buffers, and ``eps``, which changes with each refinement round, enters as
a tensor.  ``close`` drops the graphs; the solvers close their holder when
the solve returns.  A dead graph's pool stays reserved until the
allocator's cache is emptied, which a capture cannot do: a capture that
runs out of memory empties the cache and tries once more.

On the CPU there is no graph: ``chunk_graph`` returns None and the
solvers run their chunk as it is.  ``_eager_twin()`` makes every solver
that the calling thread runs inside the block take its chunks eagerly on
the card too; it exists for the checks that hold a graphed solve against
its eager twin (``chip_smoke.py``, ``tests/test_torch_cuda.py``), and no
entry point exposes it.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import torch

from ..ops import stencil_cuda as sc

# since reset_stats(): holders captured, steps replayed, capture seconds
stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
_local = threading.local()  # .eager: depth of this thread's _eager_twin()
_said = {"mesh": False}  # the slab solves' eager steps logged once
_log = logging.getLogger(__name__)


def reset_stats():
    stats.update(captures=0, replays=0, capture_s=0.0)


@contextlib.contextmanager
def _eager_twin():
    """The calling thread's solvers run their chunks eagerly on the card
    inside the block."""
    _local.eager = getattr(_local, "eager", 0) + 1
    try:
        yield
    finally:
        _local.eager -= 1


class ChunkGraph:
    """One solver's step and tail, each captured once on CUDA and replayed
    (module docstring).  ``key`` names what the bodies close over (the
    system, the preconditioner); a ``load`` with another key raises."""

    def __init__(self):
        self.key = None
        self.fns = {}  # "step", "tail": the bodies
        self.n_state = 0
        self.buffers = None  # the static inputs: the state, then constants
        self.graphs = {}  # "step", "tail": (CUDAGraph, outputs, counts)

    def load(self, key, step, tail, state, consts):
        """Set the bodies and copy a round's start (``state``, then
        ``consts``) into the static buffers, which the first load makes.
        ``step(*state, *consts)`` advances the state in place;
        ``tail(*state, *consts)`` returns the probe's tensors."""
        inputs = tuple(state) + tuple(consts)
        if self.buffers is None:
            self.key, self.n_state = key, len(state)
            self.buffers = tuple(t.clone() for t in inputs)
        elif key != self.key or len(inputs) != len(self.buffers):
            raise ValueError("ChunkGraph: loaded with another body")
        else:
            for buf, t in zip(self.buffers, inputs):
                buf.copy_(t)
        self.fns = {"step": step, "tail": tail}

    @property
    def state(self) -> tuple:
        return self.buffers[:self.n_state]

    def run(self, reps: int = 1) -> tuple:
        """Advance the state by ``reps`` steps, then return the tail's
        outputs (read them before the next run)."""
        for _ in range(reps):
            self._call("step")
        return self._call("tail")

    def _call(self, name):
        held = self.graphs.get(name)
        if held is None:
            out = self.fns[name](*self.buffers)  # eager: the warm-up
            self.graphs[name] = self._capture(name)
            if name == "step":
                stats["captures"] += 1
            return out
        graph, out, deltas = held
        graph.replay()
        sc.add_counts(deltas)
        if name == "step":
            stats["replays"] += 1
        return out

    def _capture(self, name):
        """Record ``name``'s body on a side stream, after its eager call
        was enqueued: nothing waits for the card first (``torch.cuda.graph``
        would synchronise and empty the cache), since the capture runs no
        kernel and its replays are ordered after the eager call on the
        caller's stream.  Returns (graph, outputs, launch counts)."""
        try:
            return self._record(name)
        except torch.OutOfMemoryError:
            pass
        # out of memory: dead graphs' pools and the cache hold it, which a
        # capture cannot release (the failed graph is gone by now)
        torch.cuda.empty_cache()
        return self._record(name)

    def _record(self, name):
        before = sc.snapshot_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.buffers[0].device)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.fns[name](*self.buffers)
                finally:
                    graph.capture_end()
        finally:
            deltas = sc.counts_since(before)
            sc.restore_counts(before)
        stats["capture_s"] += time.perf_counter() - t0
        return graph, out, deltas

    def close(self):
        """Drop the graphs, their outputs and the static buffers."""
        self.graphs, self.fns, self.buffers = {}, {}, None


def chunk_graph(device, graph=None, mesh=None):
    """The graph holder a solver runs its chunks through: None (the chunk
    runs as it is) on a device that is not CUDA, inside ``_eager_twin()``
    or on X slabs (a ``mesh``: a step that sums over ranks through the
    gloo backend cannot be captured, so slab solves run eagerly, and their
    launches count as they go); ``graph`` itself when it is a holder (one
    capture serving several calls, e.g. every refinement round of a
    solve); else a new holder."""
    if torch.device(device).type != "cuda" or getattr(_local, "eager", 0):
        return None
    if mesh is not None:
        if not _said["mesh"]:
            _said["mesh"] = True
            _log.info("X slabs: the PCG steps run eagerly, not as CUDA "
                      "graphs (a collective of the gloo backend cannot be "
                      "captured)")
        return None
    return graph if graph is not None else ChunkGraph()


@contextlib.contextmanager
def solve_graph(device, graph=None, mesh=None):
    """``chunk_graph`` for one solve: a holder made here is closed when
    the block ends, so its graphs do not outlive the solve."""
    holder = chunk_graph(device, graph, mesh)
    try:
        yield holder
    finally:
        if holder is not None and holder is not graph:
            holder.close()
