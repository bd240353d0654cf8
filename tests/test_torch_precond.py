"""PyTorch port, ``solve/preconditioners.py``: the schedule, the Galerkin
hierarchy, the K2 plain forms and one V-cycle against the JAX package in
float64."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.solve import preconditioners as JP  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve.refine import make_precond  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def _systems(kind, shape, dx, seed=0):
    mask = np.random.default_rng(seed).random(shape) < 0.7
    if kind == "flow":
        return (JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0,
                                          dx=dx),
                PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0,
                                          1.0, dx=dx))
    return (JS.make_cell_problem_system(jnp.asarray(mask), 2, dx=dx),
            PS.make_cell_problem_system(torch.from_numpy(mask), 2, dx=dx))


@pytest.mark.parametrize("shape,w,max_levels", [
    ((64, 64, 64), (1.0, 1.0, 1.0), 3),
    ((512, 512, 512), (1.0, 1.0, 1.0), 3),
    ((64, 64, 64), (1.0, 1.0, 0.25), 3),
    ((160, 160, 160), (1.0, 1.0, 1 / 16), 3),
    ((100, 98, 97), (1.0, 1.0, 1.0), 3),
    ((33, 20, 17), (1.0, 4.0, 0.25), 4),
    ((6, 6, 6), (1.0, 1.0, 1.0), 3),
])
def test_schedule_matches_jax(shape, w, max_levels):
    assert (PP.GalerkinMGPreconditioner._schedule_for(shape, w, max_levels)
            == JP.GalerkinMGPreconditioner._schedule_for(shape, w,
                                                         max_levels))


@pytest.mark.parametrize("kind,shape,dx", [
    ("flow", (16, 16, 12), (1.0, 1.0, 1.0)),
    ("flow", (16, 14, 12), (1.0, 1.0, 2.0)),
    ("cell", (16, 12, 10), (1.0, 0.5, 2.0)),
])
def test_galerkin_hierarchy_and_k2_plain_match_jax(kind, shape, dx):
    js, ps = _systems(kind, shape, dx)
    jm = JP.GalerkinMGPreconditioner.from_system(js)
    pm = PP.GalerkinMGPreconditioner.from_system(ps)
    assert pm.schedule == jm.schedule
    assert (pm.coarse_sweeps, pm.coarse_ratio) == (jm.coarse_sweeps,
                                                   jm.coarse_ratio)
    jf, pf = JP.fine_conductances(js), PP.fine_conductances(ps)
    assert len(pm.levels) == len(jm.levels) == 2
    rng = np.random.default_rng(1)
    for jl, pl in zip((jf,) + jm.levels, (pf,) + pm.levels):
        for name in ("diag", "cx", "cy", "cz"):
            np.testing.assert_allclose(getattr(pl, name).numpy(),
                                       np.asarray(getattr(jl, name)), **TOL)
        lshape = tuple(pl.diag.shape)
        x = rng.standard_normal(lshape)
        r = rng.standard_normal(lshape)
        np.testing.assert_allclose(
            pl.apply(torch.from_numpy(x)).numpy(),
            np.asarray(jl.apply(jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(
            pl.sweep(torch.from_numpy(x), torch.from_numpy(r), 0.9).numpy(),
            np.asarray(jl.sweep(jnp.asarray(x), jnp.asarray(r), 0.9)), **TOL)
    # a level carried across from JAX's arrays is the same operator
    lv = convert.conductance_level_from_numpy(
        *(np.asarray(getattr(jm.levels[0], n))
          for n in ("diag", "cx", "cy", "cz")), device="cpu")
    x = torch.from_numpy(rng.standard_normal(tuple(lv.diag.shape)))
    torch.testing.assert_close(lv.apply(x), pm.levels[0].apply(x),
                               rtol=1e-12, atol=1e-12)


def test_pair_helpers_match_jax():
    x = np.random.default_rng(2).standard_normal((6, 4, 8))
    for ax in range(3):
        np.testing.assert_array_equal(
            PP._pairsum(torch.from_numpy(x), ax).numpy(),
            np.asarray(JP._pairsum(jnp.asarray(x), ax)))
        for parity in (0, 1):
            np.testing.assert_array_equal(
                PP._pairsel(torch.from_numpy(x), ax, parity).numpy(),
                np.asarray(JP._pairsel(jnp.asarray(x), ax, parity)))
    for axes in ((0, 1, 2), (0, 1), (2,)):
        np.testing.assert_array_equal(
            PP._blocksum_axes(torch.from_numpy(x), axes).numpy(),
            np.asarray(JP._blocksum_axes(jnp.asarray(x), axes)))
        np.testing.assert_array_equal(
            PP._prolong_pc_axes(torch.from_numpy(x), axes).numpy(),
            np.asarray(JP._prolong_pc_axes(jnp.asarray(x), axes)))


@pytest.mark.parametrize("kind,shape,dx,opts", [
    ("flow", (16, 16, 16), (1.0, 1.0, 1.0), {}),
    ("flow", (16, 16, 12), (1.0, 1.0, 2.0), {}),
    ("cell", (16, 12, 16), (1.0, 1.0, 1.0), {}),
    ("flow", (16, 16, 16), (1.0, 1.0, 1.0), {"coarse_solver": "jacobi",
                                             "coarse_sweeps": 20}),
    ("flow", (6, 6, 6), (1.0, 1.0, 1.0), {}),
    ("flow", (16, 16, 16), (1.0, 1.0, 1.0), {"smoother": "cheby",
                                             "coarse_solver": "jacobi",
                                             "coarse_sweeps": 20}),
    ("cell", (16, 12, 16), (1.0, 1.0, 1.0), {"smoother": "cheby"}),
])
def test_vcycle_matches_jax(kind, shape, dx, opts):
    js, ps = _systems(kind, shape, dx, seed=4)
    jm = JP.GalerkinMGPreconditioner.from_system(js, **opts)
    pm = PP.GalerkinMGPreconditioner.from_system(ps, **opts)
    r = np.where(np.asarray(js.free),
                 np.random.default_rng(5).standard_normal(shape), 0.0)
    want = np.asarray(jax.jit(lambda M, v: M(v))(jm, jnp.asarray(r)))
    got = pm(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_jacobi_and_identity_match_jax():
    js, ps = _systems("flow", (8, 8, 8), (1.0, 1.0, 1.0))
    r = np.random.default_rng(6).standard_normal((8, 8, 8))
    want = np.asarray(JP.JacobiPreconditioner.from_system(js)(jnp.asarray(r)))
    got = make_precond(ps, "jacobi")(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert PP.IdentityPreconditioner()(r) is r
    assert make_precond(ps, "none") is None


def test_unported_options_raise():
    """The options that raised before they were ported now build (their
    cycles are held against the JAX package in tests/test_torch_mg.py);
    unknown names raise."""
    _, ps = _systems("flow", (16, 16, 16), (1.0, 1.0, 1.0))
    for opts in ({"transfer": "tri"}, {"cycle": "w"}, {"smoother": "cheby"}):
        m = PP.GalerkinMGPreconditioner.from_system(ps, **opts)
        (name, value), = opts.items()
        assert getattr(m, name) == value and m.w_depth == 2
        y = m(torch.where(ps.free, torch.ones((16, 16, 16),
                                              dtype=torch.float64), 0.0))
        assert bool(torch.isfinite(y).all())
    mg = make_precond(ps, "mg")
    assert isinstance(mg, PP.MultigridPreconditioner)
    assert [tuple(lv.code.shape) for lv in mg.levels] == [
        (16, 16, 16), (8, 8, 8), (4, 4, 4)]
    assert (mg.nu1, mg.nu2, mg.omega, mg.coarse_sweeps) == (2, 2, 0.8, 30)
    cheby = make_precond(ps, "cheby", {"degree": 4})
    assert isinstance(cheby, PP.ChebyshevPreconditioner)
    assert cheby.degree == 4 and cheby.diag.shape == ps.code.shape
    with pytest.raises(ValueError):
        make_precond(ps, "bogus")
    assert isinstance(make_precond(ps, "auto"), PP.GalerkinMGPreconditioner)


def _cheby_loop(apply_fn, diag, free, x, r, degree, ratio):
    """The Chebyshev iteration as ``_smooth_cheby`` ran it before its
    steps were fused into the level's: the operator, then tensor code.
    Returns the first step's (res, d, x, c0), then each later step's
    (res, d, x, c1, c2)."""
    hi = 2.2
    lo = hi / ratio
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    ft = {torch.float32: np.float32, torch.float64: np.float64}[r.dtype]
    inv_d = torch.where(free & (diag > 0),
                        1.0 / torch.where(diag > 0, diag, 1.0),
                        torch.zeros((), dtype=r.dtype))
    c0 = float(ft(1.0 / theta))
    res = r - apply_fn(x)
    d = inv_d * res * c0
    x = x + d
    states = [(res, d, x, c0)]
    two_sigma, two_over_delta = ft(2.0 * sigma), ft(2.0 / delta)
    rho = ft(1.0 / sigma)
    for _ in range(1, degree):
        res = res - apply_fn(d)
        rho_new = ft(1.0) / (two_sigma - rho)
        c1 = float(rho_new * rho)
        c2 = float(rho_new * two_over_delta)
        d = c1 * d + c2 * (inv_d * res)
        x = x + d
        rho = rho_new
        states.append((res, d, x, c1, c2))
    return states


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["flow", "cell"])
@pytest.mark.parametrize("level,shape,porosity", [
    ("fine", (9, 7, 5), 0.7),      # odd extents, blocked fine cells
    ("fine", (16, 12, 8), 0.7),
    ("coarse", (16, 12, 8), 0.2),  # Galerkin level with blocked coarse cells
])
def test_cheby_plain_steps_equal_the_loop_body(kind, level, shape, porosity,
                                               dtype):
    """``ConductanceLevel.cheby_init_plain`` and ``cheby_step_plain``, and
    the Chebyshev iteration built from them, are the loop they replace to
    the bit, clamped (flow) and periodic (cell), float32 and float64."""
    mask = torch.from_numpy(
        np.random.default_rng(7).random(shape) < porosity)
    if kind == "flow":
        ps = PS.make_tortuosity_system(mask, 0, -1.0, 1.0, dtype=dtype)
    else:
        ps = PS.make_cell_problem_system(mask, 1, dtype=dtype)
    lvl = PP.fine_conductances(ps)
    if level == "coarse":
        lvl = PP.galerkin_coarsen(lvl)
    assert bool((lvl.diag == 0).any()) and bool((lvl.diag > 0).any())
    lshape = tuple(lvl.diag.shape)
    rng = np.random.default_rng(8)
    r = torch.from_numpy(rng.standard_normal(lshape)).to(dtype)
    x0 = torch.from_numpy(rng.standard_normal(lshape)).to(dtype)
    diag, free = lvl.diag.to(dtype), lvl.free
    degree, ratio = 9, 64.0
    want = _cheby_loop(lvl.apply, diag, free, torch.zeros_like(r), r,
                       degree, ratio)
    *first, c0 = want[0]
    for g, w in zip(lvl.cheby_init_plain(r, c0), first):
        assert torch.equal(g, w)
    for before, after in zip(want, want[1:]):
        *state, c1, c2 = after
        for g, w in zip(lvl.cheby_step_plain(*before[:3], c1, c2), state):
            assert torch.equal(g, w)
    # the whole iteration through the cycle's own loop, from zero and x0
    pm = PP.GalerkinMGPreconditioner.from_system(ps)
    assert torch.equal(pm._smooth_cheby(lvl, diag, free, None, r, degree,
                                        ratio), want[-1][2])
    want0 = _cheby_loop(lvl.apply, diag, free, x0, r, degree, ratio)
    assert torch.equal(pm._smooth_cheby(lvl, diag, free, x0, r, degree,
                                        ratio), want0[-1][2])
