"""PyTorch port: the solver warm-up (``solve/warmup.py``), the graph holder
(``utils/graphs.py``) and the launch counters' bookkeeping, on the CPU.

``prime_solver`` and ``prime_cell_solver`` return None here, as the JAX
package's do off the TPU.  A handle passed as ``warm=`` (its thread's
build stood in for, since there is no ``nvcc`` here) changes no result of
``tortuosity``, ``effective_diffusivity`` or the CLI, and is joined before
the solve; a thread that raised re-raises at ``join()``."""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import openimpala_tpu as oi  # noqa: E402

import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu_torch import diffusion  # noqa: E402
from openimpala_tpu_torch.ops import stencil_cuda as sc  # noqa: E402
from openimpala_tpu_torch.props import (  # noqa: E402
    prime_cell_solver, prime_solver)
from openimpala_tpu_torch.solve import warmup  # noqa: E402
from openimpala_tpu_torch.solve.cg import cg  # noqa: E402
from openimpala_tpu_torch.utils import graphs  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402


@pytest.fixture(scope="module")
def vol():
    return make_blobs(16, 0.4, 0)


@pytest.fixture
def stand_in(monkeypatch):
    """The thread's build and launches replaced by a recorder (no nvcc and
    no card here); returns the list of kernel sets it was asked for."""
    calls = []

    def prime(names, dev, timing):
        calls.append(tuple(names))
        timing.update(built=[], build_s=0.0, load_s=0.0, launch_s=0.0)

    monkeypatch.setattr(warmup, "_warm", prime)
    return calls


def _handle(precond="auto"):
    return warmup.SolverWarmup(warmup.warm_kernels(precond), "cpu")


@pytest.mark.parametrize("device", [None, "cpu"])
def test_primes_return_none_off_cuda(device):
    kw = {} if device is None else {"device": device}
    assert prime_solver((64, 64, 64), "X", **kw) is None
    assert prime_solver((256, 256, 256), 0, extra_dirs=(1, 2), **kw) is None
    assert prime_cell_solver((64, 64, 64), **kw) is None
    # the JAX package off the TPU
    from openimpala_tpu.props.effective_diffusivity import (
        prime_cell_solver as j_cell)
    from openimpala_tpu.props.tortuosity import prime_solver as j_solver

    assert j_solver((64, 64, 64), "X", mesh=None) is None
    assert j_cell((64, 64, 64), mesh=None) is None


@pytest.mark.parametrize("precond,kernels", [
    ("auto", ("k1", "k2")), ("gmg", ("k1", "k2")), ("sa", ("k1", "k3")),
    ("samg", ("k1", "k3")), ("mg", ("k1",)), ("cheby", ("k1", "k4", "k5")),
    ("jacobi", ("k1",)), ("none", ("k1",)), (None, ("k1", "k2")),
])
def test_warm_kernels(precond, kernels):
    assert warmup.warm_kernels(precond) == kernels
    assert set(kernels) <= set(sc.SOURCES)


def test_maybe_start_rules(monkeypatch, stand_in):
    assert warmup.maybe_start("auto", device="cpu") is None
    assert warmup.maybe_start("auto") is None  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    h = warmup.maybe_start("sa", device="cuda")
    assert isinstance(h, warmup.SolverWarmup)
    h.join()
    assert h.timing["kernels"] == ["k1", "k3"]
    # every kernel of the solve loaded already: no thread
    monkeypatch.setattr(sc, "_libs", {"k1": None, "k3": None})
    assert warmup.maybe_start("sa", device="cuda") is None
    h = warmup.maybe_start("cheby", device="cuda")
    h.join()
    assert stand_in == [("k1", "k3"), ("k1", "k4", "k5")]


def test_handle_events_and_join(stand_in):
    h = _handle()
    h.wait_fill()
    for d in (0, 1, 2):  # the JAX names, which return at once here
        h.wait_fill(d, timeout=5.0)
        h.wait_build(d, timeout=5.0)
    h.join()
    h.join()  # idempotent
    assert not h._thread.is_alive() and h.timing["join_s"] >= 0.0
    assert h.timing["kernels"] == ["k1", "k2"]
    assert _handle("cheby").join() is None


def test_thread_error_reraises_at_join(monkeypatch):
    def fail(names, dev, timing):
        raise RuntimeError("nvcc failed for k1_stencil.cu")

    monkeypatch.setattr(warmup, "_warm", fail)
    h = _handle()
    with pytest.raises(RuntimeError, match="warm-up failed") as e:
        h.join()
    assert "nvcc failed" in str(e.value.__cause__)
    with pytest.raises(RuntimeError, match="warm-up failed"):
        oit.tortuosity(make_blobs(12, 0.4, 0), 1, "X", device="cpu",
                       warm=_handle())
    with pytest.raises(RuntimeError, match="warm-up failed"):
        oit.effective_diffusivity(make_blobs(12, 0.4, 0), 1, device="cpu",
                                  warm=_handle())


def test_join_times_out(monkeypatch):
    gate = threading.Event()
    monkeypatch.setattr(warmup, "_warm",
                        lambda names, dev, timing: gate.wait(10.0))
    h = _handle()
    with pytest.raises(TimeoutError):
        h.join(timeout=0.05)
    gate.set()
    h.join()


def test_warm_changes_no_tortuosity(vol, stand_in):
    plain = oit.tortuosity(vol, 1, "X", device="cpu")
    timings = {}
    h = _handle()
    warm = oit.tortuosity(vol, 1, "X", device="cpu", warm=h,
                          timings=timings)
    assert (warm.value, warm.iterations, warm.rel_res, warm.active_vf) == \
        (plain.value, plain.iterations, plain.rel_res, plain.active_vf)
    assert "warm_join" in timings and not h._thread.is_alive()
    # one handle for every direction (the CLI's direction = All)
    h = _handle()
    for d in (0, 1):
        r = oit.tortuosity(vol, 1, d, device="cpu", warm=h)
        assert r.value == oit.tortuosity(vol, 1, d, device="cpu").value
    want = oi.tortuosity(vol, 1, "X", mesh=None)
    assert abs(warm.value - want.value) <= 1e-6 * abs(want.value)


def test_warm_changes_no_deff(vol, stand_in):
    plain = oit.effective_diffusivity(vol, 1, device="cpu")
    warm = oit.effective_diffusivity(vol, 1, device="cpu",
                                     warm=_handle())
    np.testing.assert_array_equal(warm.deff, plain.deff)
    assert warm.iterations == plain.iterations


def _inputs(tmp_path, method, direction="X"):
    v = make_blobs(14, 0.45, 2)
    v.T.astype(np.uint8).tofile(tmp_path / "v.raw")
    path = tmp_path / f"{method}.inputs"
    path.write_text(
        f"filename = v.raw\ndata_path = {tmp_path}/\n"
        f"results_path = {tmp_path}/{method}_results/\n"
        "raw.width = 14\nraw.height = 14\nraw.depth = 14\n"
        "raw.datatype = UINT8\nphase_id = 1\n"
        f"calculation_method = {method}\ndirection = {direction}\n"
        "verbose = 1\n")
    return path


def _strip_times(text):
    return "\n".join(line for line in text.splitlines()
                     if "run time" not in line)


@pytest.mark.parametrize("method,direction", [
    ("flow_through", "X"), ("flow_through", "All"), ("homogenization", "X")])
def test_cli_early_warm_changes_no_result(monkeypatch, tmp_path, capsys,
                                          stand_in, method, direction):
    """Off: OPENIMPALA_NO_EARLY_WARM=1.  On: the CLI primes at reader-
    metadata time; the primes are stood in by handles (None here)."""
    inputs = _inputs(tmp_path, method, direction)
    monkeypatch.setenv("OPENIMPALA_NO_EARLY_WARM", "1")
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    off = _strip_times(capsys.readouterr().out)
    res = tmp_path / f"{method}_results" / "results.txt"
    off_txt = res.read_text() if res.exists() else None

    primes = []

    def record(name):
        def prime(shape, *a, **kw):
            primes.append((name, tuple(shape), a, kw.get("extra_dirs")))
            return _handle(kw.get("precond", "auto"))
        return prime

    monkeypatch.delenv("OPENIMPALA_NO_EARLY_WARM")
    monkeypatch.setattr(diffusion, "prime_solver", record("flow"))
    monkeypatch.setattr(diffusion, "prime_cell_solver", record("cell"))
    assert diffusion.main([str(inputs), "device=cpu"]) == 0
    on = _strip_times(capsys.readouterr().out)
    assert on == off
    if off_txt is not None:
        assert res.read_text() == off_txt
    assert len(primes) == 1 and primes[0][1] == (14, 14, 14)
    if direction == "All":
        assert primes[0][2] == (0,) and primes[0][3] == [1, 2]


def test_counts_bookkeeping():
    sc.reset_counts()
    try:
        sc._count("k2_matvec_f32")
        sc._count("k1_matvec_dot_f32", (4, 4, 4), "general")
        sc._count("k3_apply_f32", (2, 2, 2))
        with sc.uncounted():
            sc._count("k4_matvec_f32")
            sc._count("k1_matvec_dot_f32", (4, 4, 4), "general")
        assert dict(sc.launches) == {"k2_matvec_f32": 1,
                                     "k1_matvec_dot_f32": 1,
                                     "k3_apply_f32": 1}
        before = sc.snapshot_counts()
        sc._count("k1_matvec_dot_f32", (4, 4, 4), "general")
        sc._count("k1_matvec_dot_f32", (4, 4, 4), "general")
        sc.note_plain("k1", torch.zeros(1))  # a CPU tensor: not counted
        deltas = sc.counts_since(before)
        assert deltas["launches"] == {"k1_matvec_dot_f32": 2}
        assert deltas["launches_route_at"] == {
            ("k1_matvec_dot_f32", "general", (4, 4, 4)): 2}
        sc.restore_counts(before)
        assert sc.launches["k1_matvec_dot_f32"] == 1
        for _ in range(3):  # three replays
            sc.add_counts(deltas)
        assert sc.launches["k1_matvec_dot_f32"] == 7
        assert sc.launches_route["k1_matvec_dot_f32", "general"] == 7
        assert sc.launches_at["k3_apply_f32", (2, 2, 2)] == 1
        assert not sc.plain_on_cuda
    finally:
        sc.reset_counts()


def test_no_graph_off_cuda():
    assert graphs.chunk_graph("cpu") is None
    assert graphs.chunk_graph("cpu", graphs.ChunkGraph()) is None
    with graphs._eager_twin():
        assert graphs.chunk_graph("cuda") is None
        # the twin's switch is the calling thread's alone
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            graphs.chunk_graph("cuda")))
        t.start()
        t.join()
        assert isinstance(seen[0], graphs.ChunkGraph)
    h = graphs.ChunkGraph()
    assert graphs.chunk_graph("cuda", h) is h
    assert isinstance(graphs.chunk_graph("cuda"), graphs.ChunkGraph)
    with graphs.solve_graph("cpu") as g:
        assert g is None


def test_holder_first_run_is_the_eager_body():
    """A holder's bodies run on its static buffers: the step advances the
    state in place, the tail reads it; a load copies a round's start in,
    and a load with another key raises."""
    h = graphs.ChunkGraph()
    x = torch.arange(4.0)

    def step(x, k):
        x.mul_(k)

    def tail(x, k):
        return (x.sum(),)

    h.load("k", step, tail, (x,), (torch.tensor(3.0),))
    h.fns["step"](*h.buffers)
    (probe,) = h.fns["tail"](*h.buffers)
    assert probe.item() == 18.0
    assert torch.equal(h.state[0], x * 3) and torch.equal(x, torch.arange(4.0))
    h.load("k", step, tail, (torch.ones(4),), (torch.tensor(2.0),))
    assert torch.equal(h.state[0], torch.ones(4))
    with pytest.raises(ValueError):
        h.load("other", step, tail, (x,), (torch.tensor(1.0),))
    h.close()
    assert h.buffers is None and not h.graphs


def test_cg_graph_argument_is_private_and_neutral(vol):
    """On the CPU every value of ``_graph`` runs the same eager chunks."""
    from openimpala_tpu_torch.ops.stencil import make_tortuosity_system
    from openimpala_tpu_torch.solve.cg import jacobi_preconditioner

    s = make_tortuosity_system(torch.from_numpy(vol == 1), 0, -1.0, 1.0,
                               dtype=torch.float64)
    r0 = s.initial_residual(torch.zeros(vol.shape, dtype=torch.float64))
    M = jacobi_preconditioner(s)
    outs = [cg(s, r0, s.b_norm, 1e-9, 500, precond=M, _graph=g)
            for g in (None, graphs.ChunkGraph())]
    for o in outs[1:]:
        assert torch.equal(o.z, outs[0].z)
        assert int(o.iterations) == int(outs[0].iterations)


def test_jacobi_preconditioner_matches_jax(vol):
    import jax.numpy as jnp

    from openimpala_tpu.ops.stencil import make_tortuosity_system as j_make
    from openimpala_tpu.solve.cg import jacobi_preconditioner as j_jacobi
    from openimpala_tpu_torch.ops.stencil import make_tortuosity_system
    from openimpala_tpu_torch.solve.cg import jacobi_preconditioner

    active = vol == 1
    js = j_make(jnp.asarray(active), 1, -1.0, 1.0, dtype=jnp.float64)
    ps = make_tortuosity_system(torch.from_numpy(active), 1, -1.0, 1.0,
                                dtype=torch.float64)
    r = np.random.default_rng(0).random(vol.shape)
    got = jacobi_preconditioner(ps)(torch.from_numpy(r)).numpy()
    want = np.asarray(j_jacobi(js)(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
