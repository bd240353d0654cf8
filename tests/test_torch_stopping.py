"""PyTorch port: every PCG loop stops at the iteration that converges.

The port's PCG loops (``solve/cg.py::_cg_loop``, ``solve/lanes.py::
cg_lanes``, ``solve/batched.py::_batched_cg``) read their probe after
every iteration and stop at the first that shows the solve done, as the
JAX package's ``_cg_loop`` does; on CUDA the reads are pipelined
(``utils/graphs.py::iterate``: at most ``IN_FLIGHT`` done-gated steps past
the count).  On the CPU a loop executes exactly the iterations it counts:
the steps are counted here by wrapping ``_cg_step`` (the one step of the
mono loop and the lanes) and ``_batched_step``.  The counts and results are held against the JAX
package's on the same input as ``tests/test_torch_cg.py``,
``tests/test_torch_lanes.py``, ``tests/test_torch_rev.py`` and
``tests/test_torch_maxiter.py`` hold them: the mono counts equal (the
JAX package's ``_cg_loop`` and ``_cg_chunked_loop`` count the same), the
lockstep lanes' and the batched solver's within 1 per lane, tau and D to
1e-6 (the golden tolerance), the solution of one PCG in float64 to 1e-10.

What lets a loop stop early without changing its result is the done gate:
past ``done`` a step is a fixed point of z, the counter and the residual,
bit for bit (``test_done_gate_is_a_fixed_point``).

Inputs: ``make_blobs(20, 0.45, seed=2)``, phase 1 (the entry points; the
batched solver on four 10^3 crops of it); random 75 % and 70 % masks
(seeds 0 and 1234) for the carried systems of one PCG and of the lanes.
"""

import collections
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.ops import masks as JM  # noqa: E402
from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.solve import batched as JB  # noqa: E402
from openimpala_tpu.solve import lanes as JL  # noqa: E402
from openimpala_tpu.solve import preconditioners as JP  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import batched as PB  # noqa: E402
from openimpala_tpu_torch.solve import lanes as PL  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve.refine import make_precond  # noqa: E402
from openimpala_tpu_torch.utils import graphs  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

# the JAX package's solve/__init__ re-exports functions under these names
JC = importlib.import_module("openimpala_tpu.solve.cg")
JR = importlib.import_module("openimpala_tpu.solve.refine")
PC = importlib.import_module("openimpala_tpu_torch.solve.cg")
PR = importlib.import_module("openimpala_tpu_torch.solve.refine")

PRECONDS = ["auto", "jacobi", "mg", "sa", "cheby", "none"]
# held in float64 inner solves (test_tortuosity_executes_what_it_counts)
F64_INNER = ("jacobi", "none")


@pytest.fixture(scope="module")
def vol():
    return make_blobs(20, 0.45, seed=2)


@pytest.fixture(scope="module")
def crops(vol):
    return np.stack([vol[:10, :10, :10], vol[10:, :10, :10],
                     vol[:10, 10:, 10:], vol[10:, 10:, :10]])


@pytest.fixture
def executed(monkeypatch):
    """``executed(mod, name)``: wrap ``mod.name`` (a step function) so
    that each call adds one; returns the counter.  The graph statistics
    start from zero."""
    counts = collections.Counter()

    def wrap(mod, name):
        step = getattr(mod, name)

        def counting(*a, **k):
            counts[name] += 1
            return step(*a, **k)

        monkeypatch.setattr(mod, name, counting)
        return counts

    graphs.reset_stats()
    return wrap


def _require_read_every_step():
    """Off the graphs a loop reads after every step it executes."""
    st = graphs.stats
    assert st["steps"] == st["reads"] and not graphs.surplus_counts


# -- the mono PCG ------------------------------------------------------------

def _jax_problem(shape, seed=0):
    mask = np.random.default_rng(seed).random(shape) < 0.75
    js = JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0)
    x0 = jnp.where(js.free, JM.linear_ramp(shape, 0, -1.0, 1.0), 0.0)
    return mask, js, x0, js.initial_residual(x0)


def _carry(js, jm):
    ps = convert.system_from_numpy(
        np.asarray(js.code), np.asarray(js.x_forced), np.asarray(js.r0_b),
        np.asarray(js.b_norm), js.w, js.periodic, device="cpu")
    if jm is None:
        return ps, None
    levels = tuple(
        convert.conductance_level_from_numpy(
            *(np.asarray(getattr(lv, n)) for n in ("diag", "cx", "cy", "cz")),
            device="cpu")
        for lv in jm.levels)
    return ps, PP.GalerkinMGPreconditioner(
        fine=PP.MGLevel(code=ps.code, w=ps.w, periodic=ps.periodic),
        levels=levels, coarse_sweeps=jm.coarse_sweeps,
        coarse_ratio=jm.coarse_ratio, schedule=jm.schedule)


@pytest.mark.parametrize("maxiter", [7, 500])
@pytest.mark.parametrize("precond", ["gmg", "none"])
def test_cg_executes_what_it_counts(executed, precond, maxiter):
    """One PCG in float64 on a system carried from the JAX package: the
    port's count equals the JAX package's ``_cg_loop`` count (a binding
    ``maxiter`` included) and, where ``maxiter`` does not bind,
    ``_cg_chunked_loop``'s; its steps equal its count, and its history has
    one point per iteration."""
    _, js, _, r0 = _jax_problem((16, 14, 12))
    jm = (JP.GalerkinMGPreconditioner.from_system(js) if precond == "gmg"
          else JP.IdentityPreconditioner())
    loop = JC._cg_loop(js, r0, js.b_norm, 1e-10, maxiter, jm)
    chunked = JC._cg_chunked_loop(js, r0, js.b_norm, 1e-10, maxiter, jm)
    ps, pm = _carry(js, jm if precond == "gmg" else None)
    steps = executed(PC, "_cg_step")
    hist = PC.ResidualHistory()
    got = PC.cg(ps, torch.from_numpy(np.array(r0)), ps.b_norm, 1e-10,
                maxiter, precond=pm, history=hist)
    n = int(got.iterations)
    assert n == int(loop.iterations)
    assert steps["_cg_step"] == n and graphs.stats["calls"] == 1
    if maxiter == 7:
        assert n == maxiter and not bool(got.converged)
    else:  # the JAX chunks of 16 pass a binding cap; here they stop at it
        assert 7 < n == int(chunked.iterations) < maxiter
    _require_read_every_step()
    assert [it for it, _ in hist.inner] == list(range(1, n + 1))
    assert hist.inner[-1][1] == float(got.rel_res)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(loop.z),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("precond", PRECONDS)
def test_tortuosity_executes_what_it_counts(vol, executed, precond):
    """``tortuosity`` (``solve_system``'s refinement rounds, each a PCG
    call) under each preconditioner: the steps equal the count, which
    equals the JAX package's, and tau agrees to 1e-6.  The Jacobi and
    unpreconditioned paths run their inner solves in float64 in both
    packages: in float32 their counts differ by rounding (``ROADMAP.md``
    queue 3, "not a fault")."""
    inner = dict(inner_dtype=torch.float64) if precond in F64_INNER else {}
    steps = executed(PC, "_cg_step")
    got = oit.tortuosity(vol, 1, "X", precond=precond, device="cpu",
                         return_history=True, **inner)
    n = int(got.iterations)
    assert got.converged and steps["_cg_step"] == n > 0
    _require_read_every_step()
    assert [it for it, _ in got.history.inner] == list(range(1, n + 1))
    want = oi.tortuosity(vol, 1, "X", precond=precond, mesh=None,
                         **{k: jnp.float64 for k in inner})
    assert n == int(want.iterations)
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)


@pytest.mark.parametrize("precond", ["gmg", "jacobi"])
def test_solve_system_rounds_execute_what_they_count(executed, precond):
    """Several refinement rounds on one system (eps 1e-11, float32 inner
    solves to 1e-3 a round): every round's PCG executes what it counts,
    and the solution agrees with the JAX package's ``solve_system``."""
    mask, js, x0, _ = _jax_problem((16, 16, 16), seed=3)
    x_j, info_j = JR.solve_system(js.astype(jnp.float32),
                                  x0.astype(jnp.float32), eps=1e-11,
                                  maxiter=3000, precond=precond,
                                  inner_eps=1e-3)
    ps = PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0,
                                   dtype=torch.float32)
    steps = executed(PC, "_cg_step")
    hist = PC.ResidualHistory()
    x_p, info_p = PR.solve_system(
        ps, torch.from_numpy(np.array(x0)).to(torch.float32), eps=1e-11,
        maxiter=3000, precond=precond, inner_eps=1e-3, history=hist)
    n = int(info_p.iterations)
    assert info_p.converged and bool(info_j.converged)
    assert steps["_cg_step"] == n and graphs.stats["calls"] >= 3
    _require_read_every_step()
    assert len([r for r, _ in hist.outer if r >= 0]) >= 3
    assert abs(n - int(info_j.iterations)) <= 2
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=1e-7,
                               atol=1e-7)


# -- the lockstep lanes ------------------------------------------------------

def _lanes_pair(active):
    systems = [JS.make_cell_problem_system(jnp.asarray(active), k)
               for k in range(3)]
    jl = JL.LaneSystem.from_systems(systems)
    pl = convert.lane_system_from_numpy(
        np.asarray(jl.code), np.asarray(jl.x_forced), np.asarray(jl.r0_b),
        np.asarray(jl.b_norm), jl.w, jl.periodic, device="cpu")
    return systems, jl, pl


@pytest.mark.parametrize("eps", [1e-3, 1e-10])
def test_cg_lanes_executes_what_it_counts(executed, eps):
    """One lockstep PCG on a lane system carried from the JAX package: the
    steps equal the largest lane count (the loop stops when every lane is
    done), each lane within 1 of the JAX lanes, the solutions 1e-9 (the
    loose eps: where the JAX loop's chunk of 5 overshoots the largest
    count, the port stops at it)."""
    mask = np.random.default_rng(1234).random((12, 10, 8)) < 0.7
    jsys, jl, pl = _lanes_pair(mask)
    jr0 = jl.initial_residual(jnp.zeros(jl.r0_b.shape, jnp.float64))
    want = JL.cg_lanes(jl, jr0, jl.b_norm, eps, 500,
                       JR.make_precond(jsys[0], "jacobi"))
    steps = executed(PC, "_cg_step")
    r0 = pl.initial_residual(torch.zeros_like(pl.r0_b))
    got = PL.cg_lanes(pl, r0, pl.b_norm, eps, 500,
                      make_precond(pl.base(), "jacobi"))
    its = got.iterations.tolist()
    assert bool(got.converged.all())
    assert steps["_cg_step"] == max(its) and graphs.stats["calls"] == 1
    _require_read_every_step()
    assert all(abs(g - int(w)) <= 1
               for g, w in zip(its, np.asarray(want.iterations)))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("lanes", [True, False])
@pytest.mark.parametrize("precond", ["auto", "jacobi"])
def test_effective_diffusivity_executes_what_it_counts(vol, executed,
                                                       monkeypatch, precond,
                                                       lanes):
    """``effective_diffusivity`` through the lanes and through the
    sequential loop: each PCG call's steps equal its count (the largest
    lane count for the lanes), the counts equal the JAX package's and the
    tensor agrees to 1e-6."""
    steps = executed(PC, "_cg_step")
    counted = []
    loop = PL.cg_lanes if lanes else PC.cg

    def recording(*a, **k):
        res = loop(*a, **k)
        counted.append(int(res.iterations.max()))
        return res

    monkeypatch.setattr(PL if lanes else PR, "cg_lanes" if lanes else "cg",
                        recording)
    got = oit.effective_diffusivity(vol, 1, precond=precond, lanes=lanes,
                                    device="cpu")
    assert got.lanes == lanes and got.converged
    assert counted and sum(steps.values()) == sum(counted)
    _require_read_every_step()
    if not lanes:
        assert sum(counted) == sum(got.iterations)
    want = oi.effective_diffusivity(vol, 1, precond=precond, lanes=lanes,
                                    mesh=None)
    assert got.iterations == tuple(want.iterations)
    np.testing.assert_allclose(got.deff, want.deff, rtol=0, atol=1e-6)


# -- the batched solver ------------------------------------------------------

def _batched_pair(crops, k=1):
    import jax

    masks = crops == 1
    js = jax.vmap(lambda a: JS.make_cell_problem_system(
        a, k, dtype=jnp.float32))(jnp.asarray(masks))
    ps = PS.make_cell_problem_system(torch.from_numpy(masks), k,
                                     dtype=torch.float32)
    scale = np.sqrt((np.asarray(js.r0_b, np.float64) ** 2).sum(
        axis=(1, 2, 3)))
    scale = np.where(scale > 0, scale, 1.0)  # a crop with no flux: r = 0
    r_lo = (np.asarray(js.r0_b, np.float64)
            / scale[:, None, None, None]).astype(np.float32)
    return js, ps, r_lo


@pytest.mark.parametrize("eps", [1e-2, 1e-5])
@pytest.mark.parametrize("precond", ["jacobi", "cheby"])
def test_batched_cg_executes_what_it_counts(crops, executed, precond, eps):
    """One inner round of the batched PCG (lanes that finish at different
    counts): the steps equal the largest lane count, each lane within 1 of
    the JAX package's (whose loop reads every 25 iterations)."""
    js, ps, r_lo = _batched_pair(crops)
    jm = JB._make_precond(js, jnp.asarray(r_lo), precond, 12)
    pm = PB._make_precond(ps, torch.from_numpy(r_lo), precond, 12)
    _, it_j, _ = JB._batched_cg(js, jnp.asarray(r_lo),
                                jnp.ones((4,), jnp.float32), eps, 500, jm)
    steps = executed(PB, "_batched_step")
    z, it_p, rel = PB._batched_cg(ps, torch.from_numpy(r_lo), torch.ones(4),
                                  eps, 500, pm)
    assert steps["_batched_step"] == int(it_p.max()) > 0
    assert graphs.stats["calls"] == 1
    _require_read_every_step()
    assert np.abs(it_p.numpy() - np.asarray(it_j)).max() <= 1
    assert float(rel.max()) <= eps and bool(torch.isfinite(z).all())


@pytest.mark.parametrize("precond", ["jacobi", "cheby"])
def test_batched_deff_executes_what_it_counts(crops, executed, monkeypatch,
                                              precond):
    """``batched_deff`` (``rev_study(batch=True)``'s solver) on one group
    of four crops: every round's steps equal its largest lane count, the
    tensors agree with the JAX package's to 1e-6."""
    steps = executed(PB, "_batched_step")
    counted = []
    loop = PB._batched_cg

    def recording(*a, **k):
        z, it, rel = loop(*a, **k)
        counted.append(int(it.max()))
        return z, it, rel

    monkeypatch.setattr(PB, "_batched_cg", recording)
    got, conv = PB.batched_deff(crops, 1, precond=precond, device="cpu")
    want, wconv = JB.batched_deff(crops, 1, precond=precond)
    assert conv.all() and conv.tolist() == wconv.tolist()
    assert len(counted) >= 3 and steps["_batched_step"] == sum(counted)
    _require_read_every_step()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- the done gate and the loop's rules ---------------------------------------

def _bits(*ts):
    return [t.detach().numpy().tobytes() for t in ts]


def _mono_case():
    _, js, _, r0 = _jax_problem((12, 10, 8), seed=4)
    ps, _ = _carry(js, None)
    r0 = torch.from_numpy(np.array(r0)).to(torch.float32)
    system = ps.astype(torch.float32)
    M = make_precond(system, "jacobi")
    denom = torch.sqrt(torch.sum(r0 * r0))
    state = (torch.zeros_like(r0), r0.clone(), torch.zeros_like(r0),
             torch.zeros(()), torch.zeros((), dtype=torch.int32),
             torch.ones(()), torch.zeros((), dtype=torch.bool))
    return (lambda: PC._cg_step(system, M, state, denom, 1e-4)), state


def _lanes_case():
    mask = np.random.default_rng(1234).random((12, 10, 8)) < 0.7
    _, _, pl = _lanes_pair(mask)
    r0 = pl.initial_residual(torch.zeros_like(pl.r0_b))
    M = make_precond(pl.base(), "jacobi")
    L = pl.lanes
    state = (torch.zeros_like(r0), r0.clone(), torch.zeros_like(r0),
             torch.zeros((L,), dtype=r0.dtype),
             torch.zeros((L,), dtype=torch.int32),
             torch.ones((L,), dtype=r0.dtype),
             torch.zeros((L,), dtype=torch.bool))
    return (lambda: PC._cg_step(pl, M, state, pl.b_norm, 1e-6)), state


def _batched_case():
    masks = np.random.default_rng(5).random((3, 8, 8, 8)) < 0.7
    ps = PS.make_cell_problem_system(torch.from_numpy(masks), 0,
                                     dtype=torch.float32)
    r0 = ps.r0_b / torch.sqrt(torch.sum(ps.r0_b ** 2, dim=(1, 2, 3)))[
        :, None, None, None]
    M = PB._make_precond(ps, r0, "cheby", 12)
    y = M(r0)
    state = (torch.zeros_like(r0), r0.clone(), y,
             torch.sum(r0 * y, dim=(1, 2, 3)),
             torch.zeros((3,), dtype=torch.int32), torch.ones(3),
             torch.zeros((3,), dtype=torch.bool))
    return (lambda: PB._batched_step(ps, M, state, torch.ones(3), 1e-4)), \
        state


@pytest.mark.parametrize("case", ["mono", "lanes", "batched"])
def test_done_gate_is_a_fixed_point(case):
    """Step until every lane is done, then 16 more steps: z, the
    iteration counters and the residuals keep their bits (what lets a loop
    stop at the converged step while the card may run past it)."""
    step, state = {"mono": _mono_case, "lanes": _lanes_case,
                   "batched": _batched_case}[case]()
    done = state[6]
    for _ in range(500):
        step()
        if bool(done.all()):
            break
    assert bool(done.all()) and int(state[4].max()) > 1
    z, it, rel = state[0], state[4], state[5]
    before = _bits(z, it, rel)
    for _ in range(16):
        step()
    assert _bits(z, it, rel) == before
    assert bool(done.all())


@pytest.mark.parametrize("loop", ["cg", "lanes", "batched"])
def test_converged_start_runs_no_step(executed, loop):
    """A right-hand side that already meets eps (zero) counts and executes
    no iteration."""
    if loop == "cg":
        _, js, _, _ = _jax_problem((10, 9, 8))
        ps, _ = _carry(js, None)
        steps = executed(PC, "_cg_step")
        res = PC.cg(ps, torch.zeros_like(ps.r0_b), ps.b_norm, 1e-9, 100)
    elif loop == "lanes":
        mask = np.random.default_rng(1234).random((12, 10, 8)) < 0.7
        _, _, pl = _lanes_pair(mask)
        steps = executed(PC, "_cg_step")
        res = PL.cg_lanes(pl, torch.zeros_like(pl.r0_b), pl.b_norm, 1e-9,
                          100, None)
    else:
        masks = np.random.default_rng(5).random((3, 8, 8, 8)) < 0.7
        ps = PS.make_cell_problem_system(torch.from_numpy(masks), 0,
                                         dtype=torch.float32)
        r0 = torch.zeros_like(ps.r0_b)
        steps = executed(PB, "_batched_step")
        _, it, _ = PB._batched_cg(ps, r0, torch.ones(3), 1e-4, 100,
                                  PB._make_precond(ps, r0, "jacobi", 12))
        res = PC.SolveResult(z=None, iterations=it, rel_res=None,
                             converged=None)
    assert not steps and int(torch.as_tensor(res.iterations).max()) == 0
    assert graphs.stats["steps"] == graphs.stats["reads"] == 0


class _Holder:
    """A stand-in for ``ChunkGraph`` on the CPU: ``advance`` enqueues a
    step of a solve that is done at step ``done_at``; ``read`` returns
    (steps, done) of a ticket that must still be in its slot."""

    def __init__(self, done_at):
        self.done_at, self.issued, self.surplus_steps = done_at, 0, 0
        self.slots = graphs.IN_FLIGHT + 1

    def advance(self):
        self.issued += 1
        return self.issued - 1

    def read(self, ticket):
        assert self.issued - self.slots <= ticket < self.issued
        n = ticket + 1
        return [min(n, self.done_at), float(n >= self.done_at)]

    def surplus(self, steps):
        self.surplus_steps += steps


@pytest.mark.parametrize("in_flight", [0, 1, 2])
@pytest.mark.parametrize("done_at,maxiter", [(1, 50), (5, 50), (49, 50),
                                             (50, 50), (80, 50), (3, 1)])
def test_pipelined_reads_stop_within_in_flight(monkeypatch, in_flight,
                                               done_at, maxiter):
    """``graphs.iterate`` on a holder: it reads every step in order, stops
    at the first done probe (or ``maxiter``), never enqueues past
    ``maxiter``, and leaves at most ``IN_FLIGHT`` steps in flight, which
    it reports as the surplus."""
    monkeypatch.setattr(graphs, "IN_FLIGHT", in_flight)
    graphs.reset_stats()
    h = _Holder(done_at)
    seen = []

    def stop(values):
        seen.append(values[0])
        return values[1] > 0

    graphs.iterate(h, None, None, maxiter, stop)
    counted = min(done_at, maxiter)
    assert seen == list(range(1, counted + 1))
    assert h.issued == min(counted + in_flight, maxiter)
    assert h.surplus_steps == h.issued - counted <= in_flight
    st = graphs.stats
    assert (st["calls"], st["steps"], st["reads"]) == (1, h.issued, counted)
