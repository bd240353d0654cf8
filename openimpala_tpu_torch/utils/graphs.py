"""CUDA graphs for the solvers' steps: the port's counterpart of the JAX
package's ``jax.jit`` on a chunk (``solve/cg.py::_cg_chunk``,
``solve/lanes.py::_cg_chunk_lanes``, ``solve/batched.py::
_batched_cg_chunk``, the loop of ``props/tortuosity_direct.py``).

A solver's body is a ``step`` (one PCG iteration; one check interval of
``tortuosity_direct``) and a ``tail`` that packs the probe the host reads.
A ``ChunkGraph`` holds the two on CUDA.  Their inputs (the solver state,
then constants such as ``denom`` and ``eps`` as tensors) live in static
buffers: ``load`` copies a round's start into them.  The step updates the
state buffers in place and returns nothing; the tail returns its outputs,
which land in its graph's private pool.  Each body runs eagerly once (the
warm-up that capture needs: libraries loaded, K1's shared-memory attribute
set), is captured into a ``torch.cuda.CUDAGraph`` right after, while the
card still runs that eager call, and is replayed from then on.  So a
solve's first step is eager and every later one a replay.  A body may read
no device value on the host; a capture that fails raises.

The PCG loops run in one shell, ``pcg``: the holder's load, the guard of
a solve that is done at the start, ``iterate`` and the final state.  They
read the probe after every step, pipelined:
``advance`` enqueues a step and a tail that also copies the probe into a
pinned host slot, with a CUDA event behind it; ``read`` waits on that
event alone.  The host keeps ``IN_FLIGHT`` steps enqueued behind the one
whose probe it reads, so the card runs them while the host reads, and it
stops at the first probe that shows the solve done.  The steps still in
flight are done-gated no-ops (alpha pins to 0; z, the counter and the
residual do not move), so a solve executes at most ``IN_FLIGHT`` steps
past the iteration it counts, and its result keeps its bits.  A captured
copy writes to one fixed host address, so each of the ``IN_FLIGHT + 1``
slots has its own tail graph: the copy of a later step never lands in the
slot the host is reading.  Off the graphs (the CPU, the eager twin, X
slabs) a loop reads after every step and executes what it counts.
``run(reps)`` (``tortuosity_direct``, whose check interval is the
reference's ``plot_interval``) replays ``reps`` steps and the tail and
returns the tail's outputs on the device.

``capture`` records a body so for any caller: besides the PCG loops, the
slab cycle's coarsest Chebyshev solve on ``nccl`` ranks, exchanges and
all (``solve/slab_mg.py``), whose steps the host alone would pace.

Why a step and not several: a capture costs the host about the body's
enqueue time plus the instantiation, and the card waits meanwhile.  An
eager chunk whose host time matches its device time (the default cycle at
512^3) already hides its host, so capturing 16 iterations made such
solves 0.1 to 1.2 s slower; a step's capture costs a sixteenth of that,
and its in-place update needs no copy of the state.

Replays run no Python, so the kernels' launch counters
(``ops/stencil_cuda.py``) would stop counting: a capture records the
counts its Python made, puts the counters back (a capture runs nothing),
and each replay adds the recorded counts once.  ``surplus_counts`` keeps
the launches of the steps a PCG loop executed past its count: a graphed
solve's counters less those equal its eager twin's.

Everything a body takes from Python is frozen into the graph at capture:
the kernels' routes and plans, K1's tensor maps (keyed by address) and
every Python scalar.  So a graph must only ever see its own static
buffers, and ``eps``, which changes with each refinement round, enters as
a tensor.  ``close`` waits for the steps still in flight and drops the
graphs; the solvers close their holder when the solve returns.  A dead
graph's pool stays reserved until the allocator's cache is emptied, which
a capture cannot do: a capture that runs out of memory empties the cache
and tries once more.

On the CPU there is no graph: ``chunk_graph`` returns None and the
solvers run their steps as they are.  ``_eager_twin()`` makes every solver
that the calling thread runs inside the block take its steps eagerly on
the card too; it exists for the checks that hold a graphed solve against
its eager twin (``chip_smoke.py``, ``tests/test_torch_cuda.py``), and no
entry point exposes it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import threading
import time

import torch

from ..ops import stencil_cuda as sc
from .profiling import phase_timer

# Steps a graphed PCG loop keeps enqueued behind the step whose probe the
# host reads, so the card does not wait for the host's read and its next
# enqueue; each is at most one done-gated step past the converged one.
# The smallest value at which the card's idle time inside the loops stops
# falling: on an NVIDIA H100 80GB HBM3 at 700 W under the profiler
# (scripts/profile_torch_solve.py --in-flight 0 1 2 --wait spin block;
# PERF.md, PR 16), medians, ms idle inside the loops of the default
# tortuosity call: 512^3 (2 rounds) 115.1 / 22.0 / 75.1 with IN_FLIGHT 0 /
# 1 / 2, 64^3 (5 rounds) 51.5 / 34.4 / 33.0.
IN_FLIGHT = 1
# how ``read`` waits for a probe: False spins (``cudaEventSynchronize``
# under the default flags), True sleeps (``cudaEventBlockingSync``); the
# sleep left the card idle longer at IN_FLIGHT = 1 in the same runs (512^3
# 38.7 ms, 64^3 40.3 ms)
BLOCKING_WAIT = False

# since reset_stats(): holders captured, steps replayed, capture seconds;
# the PCG loops' calls, the steps they executed and the steps they read
# (what they count)
stats = {"captures": 0, "replays": 0, "capture_s": 0.0, "calls": 0,
         "steps": 0, "reads": 0}
# since reset_stats(): the launches of the steps the PCG loops executed
# past their counts (``stencil_cuda.counts_since``'s form)
surplus_counts: dict = {}
_local = threading.local()  # .eager: depth of this thread's _eager_twin()
_said = {"mesh": False}  # the slab solves' eager steps logged once
_log = logging.getLogger(__name__)


def reset_stats():
    stats.update(captures=0, replays=0, capture_s=0.0, calls=0, steps=0,
                 reads=0)
    surplus_counts.clear()


@contextlib.contextmanager
def _eager_twin():
    """The calling thread's solvers run their steps eagerly on the card
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
        self.fns = {}  # "step", "tail", "probe<slot>": the bodies
        self.n_state = 0
        self.buffers = None  # the static inputs: the state, then constants
        self.graphs = {}  # body name: (CUDAGraph, outputs, counts)
        self.slots = []  # the pinned host probes of ``advance``
        self.events = []  # one per slot, recorded behind its copy
        self.issued = 0  # the steps ``advance`` enqueued

    def load(self, key, step, tail, state, consts):
        """Set the bodies and copy a round's start (``state``, then
        ``consts``) into the static buffers, which the first load makes.
        ``step(*state, *consts)`` advances the state in place;
        ``tail(*state, *consts)`` returns the probe's tensors.  The copies
        are enqueued on the caller's stream, behind any step of an earlier
        round still in flight."""
        inputs = tuple(state) + tuple(consts)
        if self.buffers is None:
            self.key, self.n_state = key, len(state)
            self.buffers = tuple(t.clone() for t in inputs)
            self.slots = [None] * (IN_FLIGHT + 1)
            self.events = [None] * (IN_FLIGHT + 1)
        elif key != self.key or len(inputs) != len(self.buffers):
            raise ValueError("ChunkGraph: loaded with another body")
        else:
            for buf, t in zip(self.buffers, inputs):
                buf.copy_(t)
        self.fns = {"step": step, "tail": tail}
        for s in range(len(self.slots)):
            self.fns[f"probe{s}"] = functools.partial(self._to_slot, s)

    @property
    def state(self) -> tuple:
        return self.buffers[:self.n_state]

    def run(self, reps: int = 1) -> tuple:
        """Advance the state by ``reps`` steps, then return the tail's
        outputs (read them before the next run)."""
        for _ in range(reps):
            self._call("step")
        return self._call("tail")

    def advance(self) -> int:
        """Enqueue one step and the copy of its probe into the next pinned
        host slot, with the slot's event behind it; returns the step's
        ticket for ``read``.  Nothing waits for the card."""
        ticket, s = self.issued, self.issued % len(self.slots)
        self._call("step")
        self._call(f"probe{s}")
        if self.events[s] is None:
            self.events[s] = torch.cuda.Event(blocking=BLOCKING_WAIT)
        self.events[s].record()
        self.issued += 1
        return ticket

    def read(self, ticket: int) -> list:
        """The probe of the step ``advance`` gave ``ticket``, as Python
        numbers, once its copy has landed (a wait on its slot's event, not
        on the stream).  Only the last ``IN_FLIGHT + 1`` tickets can be
        read: an older slot holds a later step's probe."""
        if not self.issued - len(self.slots) <= ticket < self.issued:
            raise ValueError(f"ChunkGraph.read: ticket {ticket} is not among "
                             f"the last {len(self.slots)} of {self.issued}")
        s = ticket % len(self.slots)
        self.events[s].synchronize()
        return self.slots[s].tolist()

    def _to_slot(self, s, *buffers):
        """Slot ``s``'s tail: the probe, copied into the pinned slot (made
        by the eager call, so a capture only records the copy)."""
        (probe,) = self.fns["tail"](*buffers)
        if self.slots[s] is None:
            self.slots[s] = torch.empty(probe.shape, dtype=probe.dtype,
                                        pin_memory=True)
        self.slots[s].copy_(probe, non_blocking=True)

    def surplus(self, steps: int):
        """Add ``steps`` replays' launches to ``surplus_counts``: the
        steps a loop left in flight when it stopped."""
        for k, c in self.graphs["step"][2].items():
            surplus_counts.setdefault(k, collections.Counter()).update(
                {key: n * steps for key, n in c.items()})

    def _call(self, name):
        held = self.graphs.get(name)
        if held is None:
            out = self.fns[name](*self.buffers)  # eager: the warm-up
            self.graphs[name] = capture(self.fns[name], *self.buffers)
            if name == "step":
                stats["captures"] += 1
            return out
        graph, out, deltas = held
        graph.replay()
        sc.add_counts(deltas)
        if name == "step":
            stats["replays"] += 1
        return out

    def close(self):
        """Wait for the last step enqueued (the steps in flight copy into
        the pinned slots), then drop the graphs, their outputs, the slots
        and the static buffers."""
        with phase_timer(None, "solve/graph_close"):
            if self.issued:
                self.events[(self.issued - 1) % len(self.slots)].synchronize()
            self.graphs, self.fns, self.buffers = {}, {}, None
            self.slots, self.events, self.issued = [], [], 0


def capture(fn, *args):
    """Record ``fn(*args)`` into a CUDA graph on a side stream, after its
    eager call was enqueued: nothing waits for the card first
    (``torch.cuda.graph`` would synchronise and empty the cache), since
    the capture runs no kernel and its replays are ordered after the eager
    call on the caller's stream.  Returns (graph, outputs, launch counts):
    the counters are put back as they were, and each replay adds the
    counts once.  A capture that runs out of memory empties the cache and
    tries once more (dead graphs' pools and the cache hold it, which a
    capture cannot release; the failed graph is gone by then)."""
    with phase_timer(None, "solve/capture"):
        try:
            return _record(fn, args)
        except torch.OutOfMemoryError:
            pass
        torch.cuda.empty_cache()
        return _record(fn, args)


def _record(fn, args):
    before = sc.snapshot_counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(args[0].device)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*args)
            finally:
                graph.capture_end()
    finally:
        deltas = sc.counts_since(before)
        sc.restore_counts(before)
    stats["capture_s"] += time.perf_counter() - t0
    return graph, out, deltas


def eager_only() -> bool:
    """Whether the calling thread is inside ``_eager_twin()``."""
    return bool(getattr(_local, "eager", 0))


def iterate(holder, step, probe, maxiter: int, stop):
    """Run a PCG loop's steps until ``stop(values)``, given the probe's
    host values after each step, returns true, or ``maxiter`` steps ran.
    ``holder`` None: ``step()`` and ``probe()`` (a tensor) run as they
    are, one read per step.  A holder (its bodies loaded): ``advance``
    keeps ``IN_FLIGHT`` steps enqueued behind the one read, and never
    enqueues more than ``maxiter``; those left in flight at the stop are
    the surplus, done-gated on the card (module docstring)."""
    stats["calls"] += 1
    if holder is None:
        for _ in range(maxiter):
            step()
            stats["steps"] += 1
            stats["reads"] += 1
            if stop(probe().tolist()):
                return
        return
    queued = collections.deque()
    issued = 0
    try:
        for _ in range(maxiter):
            while len(queued) <= IN_FLIGHT and issued < maxiter:
                queued.append(holder.advance())
                issued += 1
            stats["reads"] += 1
            if stop(holder.read(queued.popleft())):
                break
    finally:
        stats["steps"] += issued
        if queued:
            holder.surplus(len(queued))


def pcg(key, step, probe, state, denom, eps, maxiter: int, stop,
        graph=None, mesh=None):
    """The shell of the PCG loops (``solve/cg.py::_cg_loop``, which
    serves ``cg`` and ``cg_lanes``, and ``solve/batched.py::
    _batched_cg``).  ``state`` is (z, r, p, rz, it, rel, done);
    ``step(state, denom, eps)`` advances it in place by one done-gated
    iteration, and ``probe(state)`` packs the tensor whose host values
    ``stop`` reads (``iterate``).  No step runs when every ``done`` is set
    at the start.  On CUDA (``solve_graph``: ``graph`` a shared holder,
    else one for this call) the holder's bodies are the step, with eps a
    tensor of the state's dtype (the value a Python float takes in the
    comparison, and no frozen constant), and the probe.  Returns the final
    (z, it, rel), copies where ``graph`` is shared: its next load
    overwrites its buffers."""
    dev = state[0].device
    with solve_graph(dev, graph, mesh) as holder:
        if holder:
            n = len(state)
            holder.load(key, lambda *a: step(a[:n], *a[n:]),
                        lambda *a: (probe(a[:n]),), state,
                        (denom, torch.full((), eps, dtype=state[0].dtype,
                                           device=dev)))
        if not bool(state[6].all()):  # every r0 already meets eps
            iterate(holder, lambda: step(state, denom, eps),
                    lambda: probe(state), maxiter, stop)
        z, _, _, _, it, rel, _ = holder.state if holder else state
        if holder and holder is graph:
            z, it, rel = z.clone(), it.clone(), rel.clone()
    return z, it, rel


def chunk_graph(device, graph=None, mesh=None):
    """The graph holder a solver runs its steps through: None (the steps
    run as they are) on a device that is not CUDA, inside
    ``_eager_twin()`` or on X slabs (a ``mesh``: a step that sums over
    ranks through the gloo backend cannot be captured, so slab solves run
    eagerly, and their launches count as they go); ``graph`` itself when
    it is a holder (one capture serving several calls, e.g. every
    refinement round of a solve); else a new holder."""
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
