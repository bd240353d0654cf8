"""PyTorch port, ``solve/fgmres.py`` against the JAX package: one restart
cycle in float64 (z, r and the norm to 1e-10, the Arnoldi steps equal),
``solve_system(method="fgmres")`` refined and unrefined with the Galerkin,
Jacobi and no preconditioner, the plateau break, and the restart depth the
CPU budget gives.

Iterations: within 2 for the multigrid preconditioner in float32; for the
Jacobi and unpreconditioned paths the float32 counts of the two packages
can spread further (rounding near the dtype's floor decides where a cycle
stops), so those are held equal in float64, without refinement."""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.solve import preconditioners as JP  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import cg as PC  # noqa: E402
from openimpala_tpu_torch.solve import fgmres as PF  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve import refine as PR  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

JF = importlib.import_module("openimpala_tpu.solve.fgmres")


def _systems(kind, shape, seed=0):
    mask = np.random.default_rng(seed).random(shape) < 0.7
    if kind == "flow":
        return (JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0),
                PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0,
                                          1.0))
    return (JS.make_cell_problem_system(jnp.asarray(mask), 0),
            PS.make_cell_problem_system(torch.from_numpy(mask), 0))


def _preconds(name, js, ps):
    if name == "gmg":
        return (JP.GalerkinMGPreconditioner.from_system(js),
                PP.GalerkinMGPreconditioner.from_system(ps))
    if name == "jacobi":
        return (JP.JacobiPreconditioner.from_system(js),
                PP.JacobiPreconditioner.from_system(ps))
    return JP.IdentityPreconditioner(), PP.IdentityPreconditioner()


@pytest.mark.parametrize("restart,eps_rel", [(20, 1e-30), (20, 1e-3),
                                             (6, 1e-30)])
@pytest.mark.parametrize("precond", ["gmg", "jacobi", "none"])
@pytest.mark.parametrize("kind,shape", [("flow", (16, 12, 16)),
                                        ("cell", (12, 12, 12))])
def test_arnoldi_cycle_matches_jax(kind, shape, precond, restart, eps_rel):
    js, ps = _systems(kind, shape)
    jm, pm = _preconds(precond, js, ps)
    if kind == "flow":
        r0 = np.array(js.initial_residual(jnp.zeros(shape)))
    else:
        r0 = np.array(js.r0_b)
    beta = float(np.sqrt((r0 * r0).sum()))
    eps_abs = eps_rel * beta
    z0 = np.zeros(shape)
    jz, jr, jn, jk = JF._arnoldi_cycle(js, jm, jnp.asarray(z0),
                                       jnp.asarray(r0), jnp.asarray(r0),
                                       jnp.asarray(eps_abs), restart)
    t0 = torch.from_numpy(r0)
    pz, pr, pn, pk = PF._arnoldi_cycle(ps, pm, torch.from_numpy(z0), t0, t0,
                                       eps_abs, restart)
    assert pk == int(jk)
    assert 1 <= pk <= restart
    if eps_rel > 1e-30 and precond == "gmg":
        assert pk < restart  # the rotated estimate ended the cycle early
    scale = float(np.abs(np.asarray(jz)).max())
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-10,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-10,
                               atol=1e-10 * float(np.abs(r0).max()))
    assert isinstance(pn, np.float64)
    # the norm as the residual: to 1e-10 of the cycle's starting norm (a
    # deep cycle ends at the rounding floor, where it is pure cancellation)
    assert abs(float(pn) - float(jn)) <= 1e-10 * beta


def test_restart_cycles_continue_from_the_explicit_residual():
    """Two cycles of depth 4: the second starts from the first's explicit
    residual, in both packages."""
    js, ps = _systems("flow", (16, 16, 16), seed=2)
    jm, pm = _preconds("gmg", js, ps)
    r0 = np.array(js.initial_residual(jnp.zeros((16, 16, 16))))
    beta = float(np.sqrt((r0 * r0).sum()))
    jz, jr = jnp.zeros_like(jnp.asarray(r0)), jnp.asarray(r0)
    t0 = torch.from_numpy(r0)
    pz, pr = torch.zeros_like(t0), t0
    for _ in range(2):
        jz, jr, jn, jk = JF._arnoldi_cycle(js, jm, jz, jr, jnp.asarray(r0),
                                           jnp.asarray(0.0), 4)
        pz, pr, pn, pk = PF._arnoldi_cycle(ps, pm, pz, pr, t0, 0.0, 4)
        assert pk == int(jk) == 4
        assert abs(float(pn) - float(jn)) <= 1e-10 * beta
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-10,
                               atol=1e-10)


@pytest.fixture(scope="module")
def vol16():
    return make_blobs(16, 0.4, seed=0)


@pytest.mark.parametrize("direction", ["X", "Z"])
@pytest.mark.parametrize("precond", ["auto", "jacobi", "none"])
def test_tortuosity_fgmres_refined_matches_jax(vol16, precond, direction):
    """float32 restart cycles inside float64 refinement (the plateau break
    armed): tau to 1e-6; iterations within 2 under the multigrid cycle."""
    kw = dict(method="fgmres", precond=precond)
    want = oi.tortuosity(vol16, 1, direction, mesh=None, **kw)
    got = oit.tortuosity(vol16, 1, direction, device="cpu", **kw)
    assert got.converged == want.converged is True
    assert got.flux_conserved == want.flux_conserved is True
    assert got.active_vf == want.active_vf
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    assert got.rel_res <= 1e-9
    if precond == "auto":
        assert abs(got.iterations - want.iterations) <= 2


@pytest.mark.parametrize("precond", ["auto", "jacobi", "none"])
def test_tortuosity_fgmres_unrefined_f64_matches_jax(vol16, precond):
    """Restart cycles in float64, no refinement (the plateau break off):
    the same iterations and tau to 1e-6."""
    kw = dict(method="gmres", precond=precond, inner_dtype=None)
    want = oi.tortuosity(vol16, 1, "Y", mesh=None, **kw)
    got = oit.tortuosity(vol16, 1, "Y", device="cpu", **kw)
    assert got.converged == want.converged is True
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    assert got.iterations == want.iterations


def test_effective_diffusivity_fgmres_matches_jax():
    vol = make_blobs(12, 0.5, seed=3)
    want = oi.effective_diffusivity(vol, 1, method="fgmres", lanes=False,
                                    mesh=None)
    got = oit.effective_diffusivity(vol, 1, method="fgmres", device="cpu")
    assert got.converged and want.converged and not got.lanes
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 2


@pytest.mark.parametrize("name", ["fgmres", "gmres", "flexgmres"])
def test_solve_system_names_and_history(name):
    mask = np.random.default_rng(1).random((12, 12, 12)) < 0.75
    ps = PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0,
                                   dtype=torch.float32)
    hist = PC.ResidualHistory()
    x, info = PR.solve_system(ps, torch.zeros((12, 12, 12)), eps=1e-9,
                              maxiter=500, method=name, precond="gmg",
                              history=hist)
    assert info.converged and info.rel_res <= 1e-9
    assert x.dtype == torch.float64
    assert hist.inner and hist.outer[0][0] == 0
    # the inner points are one per restart cycle, cumulative across rounds
    its = [h[0] for h in hist.inner]
    assert its == sorted(its) and its[-1] == info.iterations


def test_plateau_break_only_under_refinement():
    """Asked for 1e-13 in float32, the cycles plateau at the dtype's floor:
    with the break armed two cycles without progress end the solve well
    inside the budget; unarmed, the whole budget is spent."""
    js, ps = _systems("flow", (12, 12, 12), seed=3)
    ps = ps.astype(torch.float32)
    M = PP.GalerkinMGPreconditioner.from_system(ps)
    r0 = ps.initial_residual(torch.zeros((12, 12, 12)))
    hist = PC.ResidualHistory()
    armed = PF.fgmres(ps, r0, ps.b_norm, 1e-13, 400, precond=M, restart=8,
                      stall_break=True, history=hist)
    assert not armed.converged and armed.iterations < 400
    rels = [h[1] for h in hist.inner]
    assert rels[-1] > rels[-2] * 0.999 and rels[-2] > rels[-3] * 0.999
    assert armed.restart == 8 and sum(armed.cycle_steps) == armed.iterations
    unarmed = PF.fgmres(ps, r0, ps.b_norm, 1e-13, 400, precond=M,
                        restart=8, stall_break=False)
    assert not unarmed.converged and unarmed.iterations >= 400


@pytest.mark.parametrize("shape,dtype", [
    ((16, 16, 16), "float32"), ((256, 256, 256), "float64"),
    ((512, 512, 512), "float32"), ((640, 640, 640), "float32"),
    ((1024, 1024, 1024), "float32")])
def test_auto_restart_on_the_cpu_equals_jax(shape, dtype):
    """Where the device reports no memory, both packages take the 6 GiB
    basis budget: the same depth for every field size."""
    want = JF._auto_restart(jax.ShapeDtypeStruct(shape, jnp.dtype(dtype)), 20)
    got = PF._auto_restart(
        torch.empty(shape, dtype=getattr(torch, dtype), device="meta"), 20)
    assert got == want
