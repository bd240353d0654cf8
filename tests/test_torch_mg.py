"""PyTorch port, the rest of the multigrid surface against the JAX package:
``precond="mg"`` (the rediscretised hierarchy's packed codes level by
level, bit for bit, and one cycle) and the Galerkin cycle's options
``transfer="tri"``, ``cycle="w"`` and ``smoother="cheby"`` (one cycle
application to 1e-10 in float64); then tau and D_eff to 1e-6 with the
iterations within 2, the window of the multigrid paths."""

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
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve.refine import make_precond  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

CYCLE_TOL = dict(rtol=1e-10, atol=1e-10)


def _systems(kind, shape, dx, seed=0):
    """The same random mask as a JAX and a port system, float64."""
    mask = np.random.default_rng(seed).random(shape) < 0.7
    if kind == "flow":
        return (JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0,
                                          dx=dx),
                PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0,
                                          1.0, dx=dx))
    return (JS.make_cell_problem_system(jnp.asarray(mask), 1, dx=dx),
            PS.make_cell_problem_system(torch.from_numpy(mask), 1, dx=dx))


def _cycle_pair(js, ps, jm, pm, seed=5):
    """One application of each package's cycle to the same residual."""
    shape = tuple(ps.code.shape)
    r = np.where(np.asarray(js.free),
                 np.random.default_rng(seed).standard_normal(shape), 0.0)
    want = np.asarray(jax.jit(lambda M, v: M(v))(jm, jnp.asarray(r)))
    got = pm(torch.from_numpy(r)).numpy()
    return got, want


MG_CASES = [
    ("flow", (16, 16, 16), (1.0, 1.0, 1.0)),
    ("flow", (24, 16, 20), (1.0, 1.0, 2.0)),
    ("flow", (18, 16, 16), (1.0, 1.0, 1.0)),
    ("cell", (16, 16, 16), (1.0, 1.0, 1.0)),
    ("cell", (16, 24, 16), (1.0, 1.0, 2.0)),
]


@pytest.mark.parametrize("kind,shape,dx", MG_CASES)
def test_mg_hierarchy_codes_match_jax(kind, shape, dx):
    js, ps = _systems(kind, shape, dx)
    jm = JP.MultigridPreconditioner.from_system(js)
    pm = PP.MultigridPreconditioner.from_system(ps)
    assert len(pm.levels) == len(jm.levels) >= 2
    for jl, pl in zip(jm.levels, pm.levels):
        assert pl.w == jl.w and pl.periodic == jl.periodic
        assert tuple(pl.code.shape) == jl.code.shape
        np.testing.assert_array_equal(
            pl.code.view(torch.int16).numpy(),
            np.asarray(jl.code).view(np.int16))
    codes = {float(v) for v in pm.levels[-1].code.float().unique()}
    if kind == "cell":  # the constant codes of the periodic cell problem
        assert codes <= {-1.0, 6.0 if dx[2] == 1.0 else 42.0}
    else:  # a coarse free cell with no free neighbour packs to 0
        assert all(c == -1.0 or c >= 0.0 for c in codes)


@pytest.mark.parametrize("opts", [
    {}, {"nu1": 1, "nu2": 3, "omega": 0.7, "coarse_sweeps": 12}])
@pytest.mark.parametrize("kind,shape,dx", MG_CASES)
def test_mg_cycle_matches_jax(kind, shape, dx, opts):
    js, ps = _systems(kind, shape, dx, seed=4)
    jm = JP.make_multigrid_preconditioner(js, **opts)
    pm = PP.make_multigrid_preconditioner(ps, **opts)
    got, want = _cycle_pair(js, ps, jm, pm)
    np.testing.assert_allclose(got, want, **CYCLE_TOL)
    assert isinstance(make_precond(ps, "mg"), PP.MultigridPreconditioner)


OPTION_CASES = [
    ({"transfer": "tri"}, "flow", (16, 16, 16), (1.0, 1.0, 1.0)),
    ({"transfer": "tri"}, "cell", (16, 16, 16), (1.0, 1.0, 1.0)),
    ({"cycle": "w"}, "flow", (16, 16, 16), (1.0, 1.0, 1.0)),
    ({"cycle": "w", "max_levels": 4, "w_depth": 1}, "flow", (32, 16, 16),
     (1.0, 1.0, 1.0)),
    ({"cycle": "w"}, "cell", (16, 12, 16), (1.0, 1.0, 2.0)),
    ({"smoother": "cheby"}, "flow", (16, 16, 16), (1.0, 1.0, 1.0)),
    ({"smoother": "cheby"}, "flow", (16, 16, 12), (1.0, 1.0, 2.0)),
    ({"smoother": "cheby", "coarse_solver": "jacobi", "coarse_sweeps": 10},
     "cell", (16, 16, 16), (1.0, 1.0, 1.0)),
    ({"smoother": "cheby"}, "flow", (6, 6, 6), (1.0, 1.0, 1.0)),
    ({"transfer": "tri", "cycle": "w", "smoother": "cheby"}, "flow",
     (16, 16, 16), (1.0, 1.0, 1.0)),
]


@pytest.mark.parametrize("opts,kind,shape,dx", OPTION_CASES)
def test_galerkin_options_cycle_matches_jax(opts, kind, shape, dx):
    js, ps = _systems(kind, shape, dx, seed=6)
    jm = JP.GalerkinMGPreconditioner.from_system(js, **opts)
    pm = PP.GalerkinMGPreconditioner.from_system(ps, **opts)
    assert (pm.transfer, pm.cycle, pm.smoother, pm.w_depth) == (
        jm.transfer, jm.cycle, jm.smoother, jm.w_depth)
    assert pm.schedule == jm.schedule
    got, want = _cycle_pair(js, ps, jm, pm)
    np.testing.assert_allclose(got, want, **CYCLE_TOL)


@pytest.mark.parametrize("fn", ["_prolong_tri_axis", "_restrict_tri_axis"])
@pytest.mark.parametrize("periodic", [False, True])
def test_trilinear_transfers_match_jax(fn, periodic):
    x = np.random.default_rng(2).standard_normal((6, 4, 2))
    for ax in range(3):
        if fn == "_restrict_tri_axis" and x.shape[ax] % 2:
            continue
        np.testing.assert_array_equal(
            getattr(PP, fn)(torch.from_numpy(x), ax, periodic).numpy(),
            np.asarray(getattr(JP, fn)(jnp.asarray(x), ax, periodic)))
    # the restriction is the exact transpose of the prolongation
    xc = np.random.default_rng(3).standard_normal((3, 2, 4))
    xf = np.random.default_rng(4).standard_normal((6, 4, 8))
    per = (periodic, not periodic, periodic)
    lhs = float((PP._prolong_tri(torch.from_numpy(xc), per).numpy()
                 * xf).sum())
    rhs = float((xc * PP._restrict_tri(torch.from_numpy(xf), per).numpy())
                .sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_tri_refuses_semi_coarsening():
    js, ps = _systems("flow", (16, 16, 16), (1.0, 1.0, 2.0))
    with pytest.raises(ValueError, match="full coarsening"):
        JP.GalerkinMGPreconditioner.from_system(js, transfer="tri")
    with pytest.raises(ValueError, match="full coarsening"):
        PP.GalerkinMGPreconditioner.from_system(ps, transfer="tri")
    for bad in ({"transfer": "linear"}, {"cycle": "f"},
                {"smoother": "gs"}):
        with pytest.raises(ValueError, match="unknown"):
            PP.GalerkinMGPreconditioner.from_system(ps, **bad)


@pytest.fixture(scope="module")
def vol24():
    return make_blobs(24, 0.4, seed=1)


TAU_CASES = [
    ("mg", None, (1.0, 1.0, 1.0)),
    ("mg", None, (1.0, 1.0, 2.0)),
    ("auto", {"transfer": "tri"}, (1.0, 1.0, 1.0)),
    ("auto", {"cycle": "w"}, (1.0, 1.0, 1.0)),
    ("auto", {"cycle": "w"}, (1.0, 1.0, 2.0)),
    ("auto", {"smoother": "cheby"}, (1.0, 1.0, 1.0)),
]


@pytest.mark.parametrize("precond,opts,dx", TAU_CASES)
def test_tortuosity_matches_jax(vol24, precond, opts, dx):
    kw = dict(precond=precond, precond_opts=opts, dx=dx)
    want = oi.tortuosity(vol24, 1, "X", mesh=None, **kw)
    got = oit.tortuosity(vol24, 1, "X", device="cpu", **kw)
    assert got.converged == want.converged is True
    assert got.flux_conserved == want.flux_conserved is True
    assert got.active_vf == want.active_vf
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    assert abs(got.iterations - want.iterations) <= 2
    assert got.rel_res <= 1e-9


@pytest.mark.parametrize("precond,opts", [
    ("mg", None), ("auto", {"transfer": "tri"}), ("auto", {"cycle": "w"}),
    ("auto", {"smoother": "cheby"})])
def test_effective_diffusivity_matches_jax(precond, opts):
    vol = make_blobs(16, 0.5, seed=2)
    kw = dict(precond=precond, precond_opts=opts)
    want = oi.effective_diffusivity(vol, 1, lanes=False, mesh=None, **kw)
    got = oit.effective_diffusivity(vol, 1, device="cpu", **kw)
    assert got.converged and want.converged
    assert got.volume_fraction == want.volume_fraction
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 2
