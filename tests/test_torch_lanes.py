"""PyTorch port, the lockstep lanes (``solve/lanes.py``) against the port's
own sequential solver and against the JAX package's lanes on the same
systems (carried across by ``convert.lane_system_from_numpy``).

Tolerances: a lane against the mono PCG 1e-9 (the same recurrence; the
lane dot sums over three axes where the mono one sums over all); the
lockstep solve against the JAX one: iterations within 1 per lane (both run
the top form) and the solution to 1e-6, the golden tolerance;
``effective_diffusivity`` with lanes against the sequential loop 1e-9 and
against the JAX package 1e-6 with iterations within 2 (the JAX package runs
its sequential PCG in the bottom form on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.ops.stencil import (  # noqa: E402
    make_cell_problem_system as j_cell)
from openimpala_tpu.props import rev as JR  # noqa: E402
from openimpala_tpu.solve import lanes as JL  # noqa: E402
from openimpala_tpu.solve.refine import make_precond as j_make  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops.stencil import (  # noqa: E402
    make_cell_problem_system as p_cell)
from openimpala_tpu_torch.props import effective_diffusivity as PED  # noqa: E402
from openimpala_tpu_torch.solve import lanes as PL  # noqa: E402
from openimpala_tpu_torch.solve.cg import ResidualHistory, cg  # noqa: E402
from openimpala_tpu_torch.solve.refine import (  # noqa: E402
    make_precond as p_make, solve_system)
from openimpala_tpu_torch.utils.common import device_hbm_limit  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402


def _active(shape=(12, 10, 8), seed=1234):
    return np.random.default_rng(seed).random(shape) < 0.7


def _port_lanes(active, dtype=torch.float64, dx=(1.0, 1.0, 1.0)):
    systems = [p_cell(torch.from_numpy(active), k, dx, dtype=dtype)
               for k in range(3)]
    return systems, PL.LaneSystem.from_systems(systems)


def _jax_lanes(active, dtype=np.float64, dx=(1.0, 1.0, 1.0)):
    systems = [j_cell(jnp.asarray(active), k, dx, dtype=dtype)
               for k in range(3)]
    return systems, JL.LaneSystem.from_systems(systems)


def _carried(jl):
    return convert.lane_system_from_numpy(
        np.asarray(jl.code), np.asarray(jl.x_forced), np.asarray(jl.r0_b),
        np.asarray(jl.b_norm), jl.w, jl.periodic, device="cpu")


def _one_lane_matches_solve_system(system, precond):
    """``solve_system_lanes`` on a one-lane system against ``solve_system``
    on the same system, unrefined in float64: the same step, loop and
    refinement rounds, so equal iterations and x to 1e-12; the history's
    values are a tuple over the lanes and a float."""
    hists = ResidualHistory(), ResidualHistory()
    kw = dict(eps=1e-10, maxiter=500, precond=precond,
              inner_dtype=torch.float64)
    x1, one = PL.solve_system_lanes(PL.LaneSystem.from_systems([system]),
                                    history=hists[0], **kw)
    x, mono = solve_system(system, torch.zeros_like(system.r0_b),
                           history=hists[1], **kw)
    assert bool(one.converged.all()) and bool(mono.converged)
    assert int(one.iterations[0]) == int(mono.iterations) > 0
    torch.testing.assert_close(x1[0], x, rtol=0, atol=1e-12)
    assert len(hists[0].inner) == len(hists[1].inner)
    for (i1, v1), (i, v) in zip(hists[0].inner, hists[1].inner):
        assert i1 == i and isinstance(v1, tuple) and len(v1) == 1
        assert isinstance(v, float)


@pytest.mark.parametrize("precond,entry", [
    ("jacobi", "cg"), ("gmg", "cg"), ("none", "solve_system"),
    ("gmg", "solve_system")],
    ids=["jacobi", "gmg", "solve_system-none", "solve_system-gmg"])
def test_cg_lanes_matches_mono_cg(precond, entry):
    """Each lane repeats the mono PCG's iterates (the lanes never
    couple); ``entry`` "solve_system": a one-lane lockstep solve repeats
    the mono solve (``_one_lane_matches_solve_system``)."""
    systems, lsys = _port_lanes(_active())
    if entry == "solve_system":
        _one_lane_matches_solve_system(systems[0], precond)
        return
    M = p_make(systems[0], precond)
    r0 = lsys.initial_residual(torch.zeros_like(lsys.r0_b))
    res = PL.cg_lanes(lsys, r0, lsys.b_norm, 1e-10, 500, M)
    assert bool(res.converged.all())
    assert res.iterations.shape == (3,)
    for k in range(3):
        mono = cg(systems[k], systems[k].r0_b, systems[k].b_norm, 1e-10,
                  500, precond=M)
        torch.testing.assert_close(res.z[k], mono.z, rtol=0, atol=1e-9)
        assert int(res.iterations[k]) == int(mono.iterations)


def test_cg_lanes_matches_jax_on_the_same_system():
    jsys, jl = _jax_lanes(_active())
    lsys = _carried(jl)
    assert lsys.lanes == 3 and lsys.r0_b.shape == (3, 12, 10, 8)
    jr0 = jl.initial_residual(jnp.zeros(jl.r0_b.shape, jnp.float64))
    want = JL.cg_lanes(jl, jr0, jl.b_norm, 1e-10, 500,
                       j_make(jsys[0], "jacobi"))
    r0 = lsys.initial_residual(torch.zeros_like(lsys.r0_b))
    np.testing.assert_allclose(r0.numpy(), np.asarray(jr0), rtol=0,
                               atol=1e-12)
    got = PL.cg_lanes(lsys, r0, lsys.b_norm, 1e-10, 500,
                      p_make(lsys.base(), "jacobi"))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0,
                               atol=1e-9)
    for g, w in zip(got.iterations.tolist(), np.asarray(want.iterations)):
        assert abs(g - int(w)) <= 1


@pytest.mark.parametrize("precond", ["jacobi", "gmg"])
def test_solve_system_lanes_matches_jax(precond):
    active = _active((16, 12, 10), seed=5)
    _, jl = _jax_lanes(active, np.float32)
    lsys = _carried(jl)
    assert lsys.r0_b.dtype == torch.float32
    want_x, want = JL.solve_system_lanes(jl, eps=1e-9, maxiter=5000,
                                         precond=precond,
                                         inner_dtype=jnp.float32,
                                         outer_dtype=jnp.float64)
    got_x, got = PL.solve_system_lanes(lsys, eps=1e-9, maxiter=5000,
                                       precond=precond)
    assert all(got.converged) and bool(np.asarray(want.converged).all())
    assert got_x.dtype == torch.float64 and got_x.shape == (3, 16, 12, 10)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-6)
    for g, w in zip(got.iterations, np.asarray(want.iterations)):
        assert abs(g - int(w)) <= 1
    assert max(got.rel_res) <= 1e-9


def test_solve_system_lanes_unrefined_and_history():
    """inner_dtype None runs one float64 lockstep PCG; the history records
    one residual per lane at every point."""
    active = _active()
    _, lsys = _port_lanes(active, torch.float64)
    x, info = PL.solve_system_lanes(lsys, eps=1e-9, maxiter=500,
                                    precond="jacobi", inner_dtype=None)
    assert bool(info.converged.all())
    _, lsys32 = _port_lanes(active, torch.float32)
    hist = ResidualHistory()
    x32, info32 = PL.solve_system_lanes(lsys32, eps=1e-9, maxiter=5000,
                                        precond="jacobi", history=hist)
    assert all(info32.converged)
    torch.testing.assert_close(x32, x, rtol=0, atol=1e-7)
    assert hist.outer and hist.inner
    for _, rel in hist.outer + hist.inner:
        assert isinstance(rel, tuple) and len(rel) == 3
    assert max(hist.outer[-1][1]) <= 1e-9
    its = [it for it, _ in hist.inner]
    assert its == sorted(its)


def test_lanes_stall_break_ignores_converged_lanes():
    eps, inf = 1e-9, np.inf
    cases = [
        (np.array([1e-3, 1e-2, 5e-3]), np.full(3, inf)),  # first round
        (np.array([5e-10, 8e-6, 8e-6]), np.array([5e-10, 9e-6, 9e-6])),
        (np.array([5e-10, 4e-6, 8e-6]), np.array([5e-10, 9e-6, 9e-6])),
        (np.array([1e-10, 1e-10, 1e-10]), np.array([1e-6, 1e-6, 1e-6])),
    ]
    for rel, prev in cases:
        assert PL._lanes_stalled(rel, prev, eps) == JL._lanes_stalled(
            rel, prev, eps)
    assert not PL._lanes_stalled(*cases[0], eps)
    assert PL._lanes_stalled(*cases[1], eps)
    assert not PL._lanes_stalled(*cases[2], eps)


@pytest.mark.parametrize("cells,lanes,method,inner,outer", [
    # tests/test_solve.py::test_use_lanes_gate's cases
    (64 ** 3, 3, "cg", 4, 8), (2048 ** 3, 3, "cg", 4, 8),
    (64 ** 3, 3, "gmres", 4, 8), (512 ** 3, 3, "cg", 4, 8),
    # and volumes clear of both models' thresholds
    (256 ** 3, 3, "pcg", 4, 8), (400 ** 3, 3, "cg", 4, 8),
    (128 ** 3, 3, "cg", 8, 8), (200 ** 3, 1, "cg", 4, 8),
])
def test_use_lanes_gate_matches_jax_on_the_cpu(cells, lanes, method, inner,
                                               outer):
    assert device_hbm_limit("cpu") == 0
    assert PL.use_lanes(cells, lanes, method, inner, outer, device="cpu") \
        == JL.use_lanes(cells, lanes, method, inner, outer)


def test_lanes_model_holds_the_h100_measurement():
    """Three float32 lanes with float64 refinement: at least the 197.25 B
    per cell the H100 measured; 512^3 fits 85 % of an 80 GB card."""
    assert 197.25 <= PL.lanes_bytes_per_cell(3, 4, 8) < 200
    assert 512 ** 3 * PL.lanes_bytes_per_cell(3, 4, 8) < 0.85 * 79.6 * 2 ** 30


@pytest.mark.parametrize("name,dx,precond", [
    ("blob", (1.0, 1.0, 1.0), "auto"),
    ("blobs24", (1.0, 1.0, 2.0), "auto"),
    ("blobs24", (1.0, 1.0, 1.0), "jacobi"),
])
def test_effective_diffusivity_lanes(blob_phase, name, dx, precond):
    vol = blob_phase if name == "blob" else make_blobs(24, 0.5, seed=2)
    timings = {}
    lanes = oit.effective_diffusivity(vol, 1, dx=dx, precond=precond,
                                      lanes=True, device="cpu",
                                      timings=timings)
    auto = oit.effective_diffusivity(vol, 1, dx=dx, precond=precond,
                                     device="cpu")
    seq = oit.effective_diffusivity(vol, 1, dx=dx, precond=precond,
                                    lanes=False, device="cpu")
    want = oi.effective_diffusivity(vol, 1, dx=dx, precond=precond,
                                    lanes=False, mesh=None)
    for got in (lanes, auto):
        assert got.converged and max(got.rel_res) <= 1e-9
        np.testing.assert_allclose(got.deff, seq.deff, rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                                   atol=1e-6)
        for g, w in zip(got.iterations, want.iterations):
            assert abs(g - w) <= 2
        assert got.volume_fraction == want.volume_fraction
    assert auto.iterations == lanes.iterations
    assert lanes.lanes and auto.lanes and not seq.lanes
    assert {"mask_upload", "system_setup", "hierarchy_build", "solve",
            "solve/inner_round", "deff_tensor"} <= set(timings)


def test_effective_diffusivity_lanes_fields_history(blob_phase, monkeypatch):
    calls = []
    orig = PED.solve_system_lanes

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(PED, "solve_system_lanes", spy)
    got = oit.effective_diffusivity(blob_phase, 1, precond="jacobi",
                                    device="cpu", return_fields=True,
                                    return_history=True)
    assert calls == [1] and got.lanes
    assert len(got.chi) == 3 and len(got.history) == 1
    for chi in got.chi:
        assert chi.shape == blob_phase.shape and chi.dtype == torch.float64
    assert all(len(rel) == 3 for _, rel in got.history[0].outer)
    np.testing.assert_allclose(
        PED.deff_tensor(*got.chi, torch.from_numpy(blob_phase == 1)).numpy(),
        got.deff, rtol=0, atol=1e-14)
    # the gate refuses: the sequential loop, one history per direction
    monkeypatch.setattr(PED, "use_lanes", lambda *a, **k: False)
    seq = oit.effective_diffusivity(blob_phase, 1, precond="jacobi",
                                    device="cpu", return_history=True)
    assert calls == [1] and not seq.lanes and len(seq.history) == 3
    np.testing.assert_allclose(got.deff, seq.deff, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="lanes=True"):
        oit.effective_diffusivity(blob_phase, 1, method="fgmres",
                                  lanes=True, device="cpu")


def test_rev_sequential_group_takes_the_lanes(blob_phase, monkeypatch):
    """``rev_study(batch=False)`` solves each crop through
    ``effective_diffusivity``, which takes the lanes under "auto"."""
    calls = []
    orig = PED.solve_system_lanes

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(PED, "solve_system_lanes", spy)
    got = oit.rev_study(blob_phase, 1, sizes=(10,), num_samples=2,
                        batch=False, device="cpu")
    assert len(calls) == len(got) == 2
    want = JR.rev_study(blob_phase, 1, sizes=(10,), num_samples=2,
                        batch=False)
    for g, w in zip(got, want):
        assert g.converged and w.converged and g.seed == w.seed
        np.testing.assert_allclose(g.deff, np.asarray(w.deff), rtol=0,
                                   atol=1e-6)


def test_lane_system_from_numpy_roundtrip():
    _, jl = _jax_lanes(_active(), np.float32, dx=(1.0, 0.5, 2.0))
    lsys = _carried(jl)
    _, pl = _port_lanes(_active(), torch.float32, dx=(1.0, 0.5, 2.0))
    assert lsys.w == pl.w and lsys.periodic == pl.periodic
    assert torch.equal(lsys.code.view(torch.int16), pl.code.view(torch.int16))
    torch.testing.assert_close(lsys.r0_b, pl.r0_b, rtol=0, atol=1e-7)
    torch.testing.assert_close(lsys.b_norm, pl.b_norm, rtol=1e-6, atol=0)
    base = lsys.base()
    assert base.r0_b.shape == (12, 10, 8) and base.b_norm.dim() == 0
    assert lsys.astype(torch.float64).r0_b.dtype == torch.float64
