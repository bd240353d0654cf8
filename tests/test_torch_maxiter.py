"""PyTorch port: ``maxiter`` caps the Krylov iterations as it does in the
JAX package, and the routing rules of ``lanes="auto"`` and
``batch="auto"`` (pure functions of the cells and the device: on the CPU
the JAX package's rules, on a CUDA device the H100 table of ``PERF.md``,
PR 13).

The JAX package stops exactly at ``maxiter`` on the CPU
(``openimpala_tpu/solve/cg.py::_cg_loop``, ``it < maxiter``); its lanes and
batched loops read the host every ``max(2, 16 // 3)`` = 5 and 25
iterations and stop at the first read at or past a round's cap, so they
may pass it.  The port cuts the last chunk of each loop to what is left of
the cap, so no count passes ``maxiter``.

Inputs: ``make_blobs(20, 0.45, seed=2)``, phase 1 (the batched solver:
four 10^3 crops of it); the JAX package with ``mesh=None``, the port with
``device="cpu"``.  Counts are held exactly: at most ``maxiter``
everywhere; equal to the JAX package's wherever the JAX package stays
within ``maxiter`` (the mono solve always; the lanes and the batched
solver where no round of theirs ran past its cap, e.g. where 5, or 25,
divides a first round's binding cap); exactly ``maxiter`` where the JAX
package ran past it; and at an unbound ``maxiter`` (20000) equal to the
counts the port gave before the cap.  A converged τ agrees with the JAX
package's to 1e-6 relative (the golden tolerance); an unconverged one is
NaN in both.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.props import rev as JR  # noqa: E402
from openimpala_tpu.solve import batched as JB  # noqa: E402
from openimpala_tpu.solve import lanes as JL  # noqa: E402
from openimpala_tpu_torch.props import effective_diffusivity as PED  # noqa: E402
from openimpala_tpu_torch.props import rev as PRV  # noqa: E402
from openimpala_tpu_torch.solve import batched as PB  # noqa: E402
from openimpala_tpu_torch.solve import lanes as PL  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

# the port's counts at maxiter=20000 before the cap (where it never binds)
TAU_UNBOUND = {("auto", "X"): 18, ("auto", "Y"): 17,
               ("jacobi", "X"): 160, ("jacobi", "Y"): 153}
DEFF_UNBOUND = {("jacobi", True): (91, 92, 92),
                ("jacobi", False): (90, 92, 92),
                ("auto", True): (15, 15, 14), ("auto", False): (15, 15, 14)}
# per direction, the largest lane count of each inner round
BATCHED_UNBOUND = {"jacobi": [[23, 20], [23, 20], [22, 21]],
                   "cheby": [[3, 2], [3, 2], [3, 2]],
                   "rev_study": [[5, 4], [5, 4], [4, 4]]}


@pytest.fixture(scope="module")
def vol():
    return make_blobs(20, 0.45, seed=2)


def _tau_pair(vol, precond, maxiter, direction):
    want = oi.tortuosity(vol, 1, direction, precond=precond, maxiter=maxiter,
                         mesh=None)
    got = oit.tortuosity(vol, 1, direction, precond=precond,
                         maxiter=maxiter, device="cpu")
    return got, want


@pytest.mark.parametrize("direction", ["X", "Y"])
@pytest.mark.parametrize("maxiter", [3, 5, 40])
@pytest.mark.parametrize("precond",
                         ["auto", "sa", "mg", "cheby", "jacobi", "none"])
def test_tortuosity_stops_at_maxiter_as_jax(vol, precond, maxiter,
                                            direction):
    got, want = _tau_pair(vol, precond, maxiter, direction)
    assert int(got.iterations) == int(want.iterations) <= maxiter
    assert got.converged == want.converged
    assert got.active_vf == want.active_vf
    if want.converged:
        assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    else:
        assert int(got.iterations) == maxiter
        assert math.isnan(got.value) and math.isnan(want.value)


@pytest.mark.parametrize("direction", ["X", "Y"])
@pytest.mark.parametrize("precond", ["auto", "jacobi"])
def test_tortuosity_unbound_maxiter_keeps_counts(vol, precond, direction):
    got = oit.tortuosity(vol, 1, direction, precond=precond, maxiter=20000,
                         device="cpu")
    assert got.converged
    assert int(got.iterations) == TAU_UNBOUND[(precond, direction)]


@pytest.mark.parametrize("maxiter", [3, 5, 40, 20000])
@pytest.mark.parametrize("lanes", [True, False])
@pytest.mark.parametrize("precond", ["jacobi", "auto"])
def test_effective_diffusivity_counts(vol, precond, lanes, maxiter):
    got = oit.effective_diffusivity(vol, 1, precond=precond,
                                    maxiter=maxiter, lanes=lanes,
                                    device="cpu")
    want = oi.effective_diffusivity(vol, 1, precond=precond,
                                    maxiter=maxiter, lanes=lanes, mesh=None)
    assert got.lanes == lanes
    assert max(got.iterations) <= maxiter
    if max(want.iterations) <= maxiter:
        assert got.iterations == tuple(want.iterations)
        assert got.converged == want.converged
    else:  # the JAX lanes ran past maxiter; the port stops at it
        assert max(got.iterations) == maxiter
    if maxiter == 20000:
        assert got.converged
        assert got.iterations == DEFF_UNBOUND[(precond, lanes)]


def _batched_counts(mod, monkeypatch, call):
    """Per ``batched_cell_problems`` call (one direction of one group), the
    largest lane count of each inner round, from a recording stand-in for
    ``mod._batched_cg`` that changes nothing else."""
    calls = []
    cg, cells = mod._batched_cg, mod.batched_cell_problems

    def recording_cg(*a, **k):
        z, it, rel = cg(*a, **k)
        calls[-1].append(int(np.asarray(it).max()))
        return z, it, rel

    def recording_cells(*a, **k):
        calls.append([])
        return cells(*a, **k)

    monkeypatch.setattr(mod, "_batched_cg", recording_cg)
    monkeypatch.setattr(mod, "batched_cell_problems", recording_cells)
    try:
        out = call()
    finally:
        monkeypatch.setattr(mod, "_batched_cg", cg)
        monkeypatch.setattr(mod, "batched_cell_problems", cells)
    return out, calls


def _require_batched(got, want, maxiter):
    """Per direction: the port's rounds sum to at most ``maxiter``; where
    the JAX package's stay within it, the same rounds, each within 1 (the
    batched solver's window, ``tests/test_torch_rev.py``: float32 sums in
    another order), else exactly ``maxiter``."""
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sum(g) <= maxiter
        if sum(w) <= maxiter:
            assert len(g) == len(w)
            assert all(abs(a - b) <= 1 for a, b in zip(g, w))
        else:
            assert sum(g) == maxiter


@pytest.fixture(scope="module")
def crops(vol):
    return np.stack([vol[:10, :10, :10], vol[10:, :10, :10],
                     vol[:10, 10:, 10:], vol[10:, 10:, :10]])


@pytest.mark.parametrize("maxiter", [3, 7, 25, 40, 50, 20000])
@pytest.mark.parametrize("precond", ["jacobi", "cheby"])
def test_batched_counts(crops, precond, maxiter, monkeypatch):
    """``batched_deff`` (what ``rev_study(batch=True)`` calls) on one
    group of four crops, three directions."""
    kw = dict(maxiter=maxiter, precond=precond)
    (got, gconv), got_counts = _batched_counts(
        PB, monkeypatch, lambda: PB.batched_deff(crops, 1, device="cpu",
                                                 **kw))
    (want, wconv), want_counts = _batched_counts(
        JB, monkeypatch, lambda: JB.batched_deff(crops, 1, **kw))
    _require_batched(got_counts, want_counts, maxiter)
    if got_counts == want_counts:
        assert gconv.tolist() == wconv.tolist()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if maxiter == 20000:
        assert gconv.all() and got_counts == BATCHED_UNBOUND[precond]


@pytest.mark.parametrize("maxiter", [3, 7, 20000])
def test_rev_study_batched_counts(vol, maxiter, monkeypatch):
    """``rev_study(batch=True)``: four 10^3 crops drawn by the study."""
    kw = dict(sizes=(10,), num_samples=4, maxiter=maxiter, batch=True)
    got, got_counts = _batched_counts(
        PB, monkeypatch, lambda: oit.rev_study(vol, 1, device="cpu", **kw))
    want, want_counts = _batched_counts(
        JB, monkeypatch, lambda: JR.rev_study(vol, 1, **kw))
    _require_batched(got_counts, want_counts, maxiter)
    assert [s.seed for s in got] == [s.seed for s in want]
    if maxiter == 20000:
        assert all(s.converged for s in got)
        assert got_counts == BATCHED_UNBOUND["rev_study"]


# -- the routing rules --------------------------------------------------------

EDGES = (8, 16, 32, 63, 64, 65, 96, 97, 112, 128, 192, 256, 384, 407, 408,
         512, 1024, 2048)
# an 80 GB card's memory
H100_BYTES = 80 * 10 ** 9


@pytest.mark.parametrize("n", EDGES)
def test_auto_lanes_on_the_cpu_is_the_jax_gate(n):
    """Three lanes, as ``effective_diffusivity`` asks (the two memory
    models part between 320^3 and 378^3, which no edge here is in)."""
    cells = n ** 3
    assert PL.lanes_pay(cells, "cpu")
    assert PL.use_lanes(cells, 3, "cg", 4, 8, device="cpu") == \
        JL.use_lanes(cells, 3, "cg", 4, 8)


@pytest.mark.parametrize("n", EDGES)
def test_auto_lanes_on_the_card_follows_the_h100_table(n, monkeypatch):
    """The lanes paid up to 128^3 (``CUDA_LANES_MAX_CELLS``); under a
    mesh only the memory gate decides."""
    monkeypatch.setattr(PL, "device_hbm_limit", lambda device=None: H100_BYTES)
    cells = n ** 3
    assert PL.CUDA_LANES_MAX_CELLS == 128 ** 3
    assert PL.lanes_pay(cells, "cuda") == (n <= 128)
    assert PL.lanes_pay(cells, "cuda:0") == (n <= 128)
    assert PL.lanes_pay(cells, "cuda", mesh=object())
    auto = PL.lanes_pay(cells, "cuda") and PL.use_lanes(cells, 3, "cg", 4, 8,
                                                        device="cuda")
    assert auto == (n <= 128)


def test_effective_diffusivity_asks_lanes_pay(vol, monkeypatch):
    """``lanes="auto"`` takes the lanes only where ``lanes_pay`` says so
    for the run's device, then the memory gate."""
    asked = []

    def pay(cells, device, mesh=None):
        asked.append((cells, torch.device(device).type, mesh))
        return False

    monkeypatch.setattr(PED, "lanes_pay", pay)
    res = oit.effective_diffusivity(vol, 1, precond="jacobi", device="cpu")
    assert not res.lanes and asked == [(vol.size, "cpu", None)]
    forced = oit.effective_diffusivity(vol, 1, precond="jacobi", lanes=True,
                                       device="cpu")
    assert forced.lanes and len(asked) == 1
    np.testing.assert_allclose(res.deff, forced.deff, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", EDGES)
def test_auto_batch_on_the_cpu_is_the_jax_rule(n):
    for n_group in (1, 2, 64):
        assert PRV._resolve_batch("auto", (n,) * 3, n_group, {},
                                  device="cpu") == JR._resolve_batch(
            "auto", (n,) * 3, n_group, {})


@pytest.mark.parametrize("n", EDGES)
def test_auto_batch_on_the_card_follows_the_h100_table(n):
    """The batched solver was faster up to 112^3 (``PERF.md``, PR 13)."""
    assert PRV.auto_batch_max_cells("cuda") == 112 ** 3
    assert PRV.auto_batch_max_cells("cpu") == JR.AUTO_BATCH_MAX_CELLS
    assert PRV._resolve_batch("auto", (n,) * 3, 64, {},
                              device="cuda") == (n <= 112)
    assert not PRV._resolve_batch("auto", (n,) * 3, 1, {}, device="cuda")
    for batch in (True, False):
        assert PRV._resolve_batch(batch, (n,) * 3, 64, {},
                                  device="cuda") == batch
