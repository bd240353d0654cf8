"""PyTorch port, ``solve/sa.py``: the support arithmetic, the probed
smoothed-aggregation hierarchy, the V- and W-cycle, and ``precond="sa"``
through ``solve_system`` and ``tortuosity`` against the JAX package on the
same inputs, in float64 on a 24^3 labyrinth (clamped) and a 20^3 periodic
cell system.  The JAX hierarchies are built once per module.

Tolerances: coefficients 1e-12 (the same probes in the same order; only
roundings of the roll sums differ), one cycle 1e-10, the solution 1e-8,
tau 1e-6; iterations within 1 (top- against bottom-form PCG rounding)."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.ops.floodfill import flood_fill_host  # noqa: E402
from openimpala_tpu.ops.masks import linear_ramp  # noqa: E402
from openimpala_tpu.solve import sa as JSA  # noqa: E402
from openimpala_tpu.solve.refine import solve_system as j_solve  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve import refine as PR  # noqa: E402
from openimpala_tpu_torch.solve import sa as PSA  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_sample_data import make_blobs  # noqa: E402


SA_OPTS = {"max_levels": 3}


def _labyrinth(n, seed=3, porosity=0.45):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    field = gaussian_filter(rng.standard_normal((n,) * 3), 1.5, mode="wrap")
    phase = field < np.quantile(field, porosity)
    phase[:, n // 2, n // 2] = True
    rin, rout = flood_fill_host(phase, 0)
    return rin & rout


@pytest.fixture(scope="module")
def built():
    """kind -> (JAX system, port system, JAX SA-MG, port SA-MG), each
    hierarchy built by its own package's ``from_system``."""
    out = {}
    for kind, n in (("flow", 24), ("cell", 20)):
        active = _labyrinth(n)
        if kind == "flow":
            js = JS.make_tortuosity_system(jnp.asarray(active), 0, -1.0, 1.0,
                                           dtype=jnp.float64)
            ps = PS.make_tortuosity_system(torch.from_numpy(active), 0, -1.0,
                                           1.0, dtype=torch.float64)
        else:
            js = JS.make_cell_problem_system(jnp.asarray(active), 0,
                                             dtype=jnp.float64)
            ps = PS.make_cell_problem_system(torch.from_numpy(active), 0,
                                             dtype=torch.float64)
        out[kind] = (js, ps, JSA.SAMGPreconditioner.from_system(js),
                     PSA.SAMGPreconditioner.from_system(ps))
    return out


def _carry(jm, **static):
    """The JAX preconditioner's leaves as the port's object."""
    fields = dict(nu1=jm.nu1, nu2=jm.nu2, omega=jm.omega,
                  coarse_sweeps=jm.coarse_sweeps, sa_depth=jm.sa_depth,
                  om_sa=jm.om_sa, cycle=jm.cycle, w_depth=jm.w_depth)
    fields.update(static)
    return convert.sa_preconditioner_from_numpy(
        np.asarray(jm.fine.code), jm.fine.w, jm.fine.periodic,
        np.asarray(jm.dinv0),
        [(np.asarray(l.packed), l.offsets, l.nn) for l in jm.levels],
        device="cpu", **fields)


def _free_field(js, seed):
    shape = js.free.shape
    return np.where(np.asarray(js.free),
                    np.random.default_rng(seed).standard_normal(shape), 0.0)


# -- static support arithmetic ----------------------------------------------


def test_support_arithmetic_matches_jax():
    for r in (0, 1, 2, 3):
        assert PSA._l1_ball(r) == JSA._l1_ball(r)
    b1 = PSA._l1_ball(1)
    b3 = PSA._minkowski(PSA._minkowski(b1, b1), b1)
    assert b3 == JSA._minkowski(JSA._minkowski(b1, b1), b1)
    sup1 = PSA._coarsen_support(b3)
    assert sup1 == JSA._coarsen_support(b3) and len(sup1) == 33
    smo = PSA._nn_filter(sup1)
    assert smo == JSA._nn_filter(sup1) and len(smo) == 27
    sup2 = PSA._coarsen_support(
        PSA._minkowski(PSA._minkowski(smo, sup1), smo))
    assert sup2 == JSA._coarsen_support(
        JSA._minkowski(JSA._minkowski(smo, sup1), smo)) and len(sup2) == 125
    assert PSA._coarsen_support(sup2) == JSA._coarsen_support(sup2)
    assert PSA.OM_SA == JSA.OM_SA


@pytest.mark.parametrize("shape,periodic", [
    ((12, 12, 12), (False, False, False)),
    ((10, 10, 10), (True, True, True)),
    ((12, 7, 9), (True, True, False)),
    ((4, 4, 4), (True, True, True)),
    ((256, 256, 256), (True, False, True)),
])
def test_spacing_matches_jax(shape, periodic):
    for sup in (PSA._l1_ball(1), PSA._coarsen_support(PSA._l1_ball(3))):
        got = PSA._spacing(sup, shape, periodic)
        assert got == JSA._spacing(sup, shape, periodic)
        for ax in range(3):
            if periodic[ax]:
                assert shape[ax] % got[ax] == 0


# -- the probed hierarchy ------------------------------------------------------


@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_from_system_matches_jax(built, kind):
    js, ps, jm, pm = built[kind]
    assert len(pm.levels) == len(jm.levels) == 2
    np.testing.assert_allclose(pm.dinv0.numpy(), np.asarray(jm.dinv0),
                               rtol=1e-14, atol=0)
    for jl, pl in zip(jm.levels, pm.levels):
        assert pl.offsets == jl.offsets and pl.nn == jl.nn
        assert (0, 0, 0) == pl.offsets[0]
        assert pl.packed.is_contiguous() and pl.packed.dtype == torch.float64
        np.testing.assert_allclose(pl.packed.numpy(), np.asarray(jl.packed),
                                   rtol=1e-12, atol=1e-12)
    assert (pm.nu1, pm.nu2, pm.omega, pm.coarse_sweeps, pm.sa_depth,
            pm.om_sa, pm.cycle, pm.w_depth) == (
        jm.nu1, jm.nu2, jm.omega, jm.coarse_sweeps, jm.sa_depth, jm.om_sa,
        jm.cycle, jm.w_depth)


def test_probed_operator_matches_explicit_galerkin(built):
    """The probed level-1 stencil equals Ps^T A Ps applied matrix-free to a
    random coarse vector."""
    js, ps, _, pm = built["flow"]
    lvl = pm.levels[0]
    xc = torch.from_numpy(
        np.random.default_rng(0).standard_normal(tuple(lvl.diag.shape)))
    p = pm._prolong0(xc, pm.fine.free, torch.float64)
    q = pm.fine.apply(p)
    stq = q - pm.om_sa * pm.fine.apply(pm.dinv0 * q)
    want = PP._blocksum_axes(stq, (0, 1, 2))
    torch.testing.assert_close(lvl.apply(xc), want, rtol=1e-10, atol=1e-10)


def test_coeff_dtype_casts_after_the_build(built):
    _, ps, _, pm = built["flow"]
    low = PSA.SAMGPreconditioner.from_system(ps, coeff_dtype=torch.bfloat16)
    for a, b in zip(low.levels, pm.levels):
        assert a.packed.dtype == torch.bfloat16 and a.offsets == b.offsets
        assert torch.equal(a.packed, b.packed.to(torch.bfloat16))
    r = torch.from_numpy(_free_field(built["flow"][0], 9))
    assert torch.isfinite(low(r)).all() and low(r).dtype == torch.float64


# -- the cycle ----------------------------------------------------------------


@pytest.mark.parametrize("kind,cycle", [("flow", "v"), ("flow", "w"),
                                        ("cell", "v")])
def test_cycle_on_converted_preconditioner_matches_jax(built, kind, cycle):
    js, _, jm, pm_own = built[kind]
    import dataclasses

    jm = dataclasses.replace(jm, cycle=cycle)
    pm = _carry(jm)
    assert pm.cycle == cycle
    r = _free_field(js, 5)
    want = np.asarray(jax.jit(lambda M, v: M(v))(jm, jnp.asarray(r)))
    got = pm(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    # the port's own hierarchy applies the same cycle
    own = dataclasses.replace(pm_own, cycle=cycle)(torch.from_numpy(r))
    np.testing.assert_allclose(own.numpy(), want, rtol=1e-9, atol=1e-9)


def test_vcycle_is_symmetric(built):
    """<u, M v> == <M u, v>: a valid PCG preconditioner."""
    js, _, _, pm = built["flow"]
    u = torch.from_numpy(_free_field(js, 1))
    v = torch.from_numpy(_free_field(js, 2))
    a = float(torch.sum(u * pm(v)))
    b = float(torch.sum(pm(u) * v))
    assert a == pytest.approx(b, rel=1e-10)


def test_volume_too_small_to_coarsen_matches_jax():
    mask = np.random.default_rng(0).random((6, 6, 6)) < 0.8
    js = JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0)
    ps = PS.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0)
    jm = JSA.SAMGPreconditioner.from_system(js, coarse_sweeps=7)
    pm = PSA.SAMGPreconditioner.from_system(ps, coarse_sweeps=7)
    assert pm.levels == () == jm.levels
    r = _free_field(js, 3)
    np.testing.assert_allclose(pm(torch.from_numpy(r)).numpy(),
                               np.asarray(jm(jnp.asarray(r))),
                               rtol=1e-12, atol=1e-12)


# -- through solve_system and tortuosity ---------------------------------------


def test_solve_system_sa_matches_jax(built):
    js, ps, _, _ = built["flow"]
    shape = tuple(ps.code.shape)
    x0 = np.where(np.asarray(js.free),
                  np.asarray(linear_ramp(shape, 0, -1.0, 1.0, jnp.float64)),
                  0.0)
    x_j, info_j = j_solve(js, jnp.asarray(x0), eps=1e-10, maxiter=500,
                          precond="sa", inner_dtype=None,
                          outer_dtype=jnp.float64)
    x_p, info_p = PR.solve_system(ps, torch.from_numpy(x0), eps=1e-10,
                                  maxiter=500, precond="sa",
                                  inner_dtype=None)
    assert bool(info_p.converged) and bool(info_j.converged)
    assert abs(int(info_p.iterations) - int(info_j.iterations)) <= 1
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-8)
    # fewer iterations than the Galerkin-PC cycle, the point of SA
    _, info_g = PR.solve_system(ps, torch.from_numpy(x0), eps=1e-10,
                                maxiter=500, precond="gmg", inner_dtype=None)
    assert int(info_p.iterations) < int(info_g.iterations)


@pytest.fixture(scope="module")
def jax_tau_sa():
    """32^3 blobs, three levels (16^3 with 33 taps, 8^3 with 125): both
    SA-smoothed transfers, and a JAX build that stays short."""
    vol = make_blobs(32, 0.4, seed=1)
    return vol, oi.tortuosity(vol, 1, "X", precond="sa", mesh=None,
                              precond_opts=SA_OPTS)


@pytest.mark.parametrize("name", ["sa", "samg"])
def test_tortuosity_sa_matches_jax(jax_tau_sa, name):
    vol, want = jax_tau_sa
    timings = {}
    got = oit.tortuosity(vol, 1, "X", precond=name, device="cpu",
                         precond_opts=SA_OPTS, timings=timings)
    assert got.converged and want.converged
    assert got.flux_conserved and want.flux_conserved
    assert got.active_vf == want.active_vf
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    assert abs(got.iterations - want.iterations) <= 1
    assert timings["solve/hierarchy_build"] > 0


def test_make_precond_names(built):
    _, ps, _, _ = built["flow"]
    small = PS.make_tortuosity_system(
        torch.from_numpy(np.random.default_rng(0).random((8, 8, 8)) < 0.8),
        0, -1.0, 1.0)
    for name in ("sa", "samg"):
        m = PR.make_precond(small, name, {"cycle": "w", "coarse_sweeps": 5})
        assert isinstance(m, PSA.SAMGPreconditioner)
        assert (m.cycle, m.coarse_sweeps, len(m.levels)) == ("w", 5, 1)
    assert isinstance(PR.make_precond(small, "mg"),
                      PP.MultigridPreconditioner)
    for name in ("cheby", "chebyshev"):
        assert isinstance(PR.make_precond(small, name),
                          PP.ChebyshevPreconditioner)
    with pytest.raises(ValueError, match="cycle"):
        PR.make_precond(small, "sa", {"cycle": "f"})
