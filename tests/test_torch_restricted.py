"""PyTorch port, the explicit ``(diag, free)`` operator and its one user:
``apply_restricted_plain`` (the plain form kernels K4 and K5 are held
against on the card) against the two JAX Pallas kernels it stands for, run
in interpret mode as ``tests/test_pallas.py`` runs them, and against
``apply_restricted_xla``; then ``ChebyshevPreconditioner`` against the JAX
one on the same residual.

Tolerances: 1e-6 in float32 (the Pallas kernels' own test tolerance; v2 is
held to 1e-5 there), 1e-12 in float64, the fused dot 1e-5 relative in
float32 (one float32 sum against another), the polynomial 1e-10 in
float64."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu.ops.stencil_pallas import (  # noqa: E402
    stencil_matvec_pallas,
    stencil_matvec_pallas_v2,
)
from openimpala_tpu.solve import preconditioners as JP  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.solve import preconditioners as PP  # noqa: E402
from openimpala_tpu_torch.solve import refine as PRF  # noqa: E402

PALLAS_SHAPE = (10, 16, 128)  # meets the TPU kernel's (Y%8, Z%128) contract
F32 = dict(rtol=1e-6, atol=1e-6)
F64 = dict(rtol=1e-12, atol=1e-12)


def _jax_system(kind, shape, seed, dtype, dx=(1.0, 1.0, 1.0)):
    mask = np.random.default_rng(seed).random(shape) < 0.7
    if kind == "flow":
        return JS.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0,
                                         dx=dx, dtype=dtype)
    return JS.make_cell_problem_system(jnp.asarray(mask), 1, dx=dx,
                                       dtype=dtype)


def _leaves(js, np_dtype, seed=5):
    """(x, full diag, free) of a JAX system as numpy arrays."""
    shape = tuple(js.code.shape)
    free = np.array(js.free)  # a writable copy, for torch.from_numpy
    x = np.where(free, np.random.default_rng(seed).standard_normal(shape),
                 0.0).astype(np_dtype)
    diag = np.broadcast_to(np.asarray(js.diag), shape).astype(np_dtype)
    return x, np.ascontiguousarray(diag), free


@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_plain_matches_pallas_matvec_with_dot(kind):
    js = _jax_system(kind, PALLAS_SHAPE, 11, jnp.float32)
    x, diag, free = _leaves(js, np.float32)
    want, wdot = stencil_matvec_pallas(
        jnp.asarray(x), jnp.asarray(diag), js.free, js.w, js.periodic,
        with_dot=True, interpret=True)
    got, dot = PS.apply_restricted_with_dot(
        torch.from_numpy(x), torch.from_numpy(diag),
        torch.from_numpy(free), js.w, js.periodic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert float(dot) == pytest.approx(float(wdot), rel=1e-5)
    # an int8 mask, as the kernels take it, is the same operator
    got8 = PS.apply_restricted(
        torch.from_numpy(x), torch.from_numpy(diag),
        torch.from_numpy(free.astype(np.int8)), js.w, js.periodic)
    assert torch.equal(got8, got)


def test_plain_matches_pallas_matvec_scalar_diag():
    """The cell problem's constant diagonal as a 0-d scalar (the Pallas
    kernel's SMEM form)."""
    js = _jax_system("cell", PALLAS_SHAPE, 12, jnp.float32)
    x, _, free = _leaves(js, np.float32)
    want = stencil_matvec_pallas(jnp.asarray(x), jnp.float32(6.0), js.free,
                                 js.w, js.periodic, interpret=True)
    got = PS.apply_restricted(torch.from_numpy(x), torch.tensor(6.0),
                              torch.from_numpy(free), js.w, js.periodic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("shape", [(10, 16, 128), (9, 16, 128),
                                   (32, 24, 256)])
def test_plain_matches_pallas_v2(shape):
    js = _jax_system("flow", shape, 13, jnp.float32)
    x, diag, free = _leaves(js, np.float32)
    want = stencil_matvec_pallas_v2(jnp.asarray(x), jnp.asarray(diag),
                                    js.free, js.w, js.periodic,
                                    interpret=True)
    got = PS.apply_restricted(torch.from_numpy(x), torch.from_numpy(diag),
                              torch.from_numpy(free), js.w, js.periodic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("np_dtype,tol", [(np.float32, F32),
                                          (np.float64, F64)])
@pytest.mark.parametrize("kind,shape,dx", [
    ("flow", (12, 10, 8), (1.0, 1.0, 1.0)),
    ("flow", (9, 7, 5), (1.0, 0.5, 2.0)),
    ("cell", (12, 10, 8), (1.0, 1.0, 1.0)),
    ("cell", (2, 1, 3), (1.0, 0.5, 2.0)),
])
def test_plain_matches_xla_full_and_scalar_diag(kind, shape, dx, np_dtype,
                                                tol):
    jdt = jnp.float32 if np_dtype is np.float32 else jnp.float64
    js = _jax_system(kind, shape, 14, jdt, dx=dx)
    x, diag, free = _leaves(js, np_dtype)
    xt, ft = torch.from_numpy(x), torch.from_numpy(free)
    want = JS.apply_restricted_xla(jnp.asarray(x), jnp.asarray(diag),
                                   js.free, js.w, js.periodic)
    got, dot = PS.apply_restricted_with_dot(xt, torch.from_numpy(diag), ft,
                                            js.w, js.periodic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert float(dot) == pytest.approx(
        float(np.sum(x.astype(np.float64) * np.asarray(want, np.float64))),
        rel=1e-5 if np_dtype is np.float32 else 1e-12, abs=1e-12)
    d0 = float(diag.max())
    want0 = JS.apply_restricted_xla(jnp.asarray(x), jnp.asarray(d0, jdt),
                                    js.free, js.w, js.periodic)
    got0 = PS.apply_restricted(xt, torch.tensor(d0, dtype=xt.dtype), ft,
                               js.w, js.periodic)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), **tol)


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, True, True),
                                      (True, False, True)])
@pytest.mark.parametrize("diag_form", ["scalar", "lane", "full"])
def test_batched_plain_equals_loop_over_lanes(periodic, diag_form):
    """A batch is its lanes one by one: the wrap never crosses a lane."""
    rng = np.random.default_rng(15)
    B, shape, w = 3, (5, 4, 6), (1.0, 4.0, 0.25)
    x = torch.from_numpy(rng.standard_normal((B,) + shape))
    free = torch.from_numpy(rng.random((B,) + shape) < 0.7)
    if diag_form == "scalar":
        diag = torch.tensor(10.5, dtype=torch.float64)
        lane_diag = [diag] * B
    elif diag_form == "lane":
        diag = torch.from_numpy(rng.random(B) + 10.0)
        lane_diag = list(diag)
    else:
        diag = torch.from_numpy(rng.random((B,) + shape) + 10.0)
        lane_diag = list(diag)
    out, dot = PS.apply_restricted_with_dot(x, diag, free, w, periodic)
    assert out.shape == x.shape and dot.shape == (B,)
    for b in range(B):
        ob, db = PS.apply_restricted_with_dot(x[b], lane_diag[b], free[b], w,
                                              periodic)
        assert torch.equal(out[b], ob)
        assert float(dot[b]) == pytest.approx(float(db), rel=1e-13)
        want = JS.apply_restricted_xla(
            jnp.asarray(x[b].numpy()), jnp.asarray(lane_diag[b].numpy()),
            jnp.asarray(free[b].numpy()), w, periodic)
        np.testing.assert_allclose(ob.numpy(), np.asarray(want), **F64)


def test_dispatch_rule_follows_the_shapes():
    x3, x4 = torch.zeros(4, 4, 4), torch.zeros(2, 4, 4, 4)
    s, lane = torch.tensor(6.0), torch.zeros(2)
    assert PS.restricted_kernel(x3, x3, False) == "k5"
    assert PS.restricted_kernel(x3, x3, True) == "k4"
    assert PS.restricted_kernel(x3, s, False) == "k4"
    assert PS.restricted_kernel(x4, x4, False) == "k4"
    assert PS.restricted_kernel(x4, lane, True) == "k4"


# -- ChebyshevPreconditioner ------------------------------------------------


def _cheby_pair(kind, shape, dx, opts):
    js = _jax_system(kind, shape, 21, jnp.float64, dx=dx)
    jm = JP.ChebyshevPreconditioner.from_system(js, **opts)
    pm = convert.chebyshev_preconditioner_from_numpy(
        np.asarray(jm.diag), np.asarray(jm.free), jm.w, jm.periodic,
        jm.degree, jm.hi, jm.ratio, device="cpu")
    return js, jm, pm


@pytest.mark.parametrize("kind,shape,dx,opts", [
    ("flow", (12, 10, 8), (1.0, 1.0, 1.0), {}),
    ("flow", (9, 7, 5), (1.0, 0.5, 2.0), {"degree": 12}),
    ("cell", (12, 10, 8), (1.0, 1.0, 1.0), {"degree": 12}),
    ("cell", (8, 8, 8), (1.0, 1.0, 2.0), {"degree": 5, "hi": 2.2,
                                          "ratio": 16.0}),
])
def test_chebyshev_matches_jax(kind, shape, dx, opts):
    js, jm, pm = _cheby_pair(kind, shape, dx, opts)
    free = np.asarray(js.free)
    r = np.where(free, np.random.default_rng(22).standard_normal(shape), 0.0)
    want = np.asarray(jax.jit(lambda M, v: M(v))(jm, jnp.asarray(r)))
    got = pm(torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    # from_system builds the same object from the port's own system
    ps = convert.system_from_numpy(
        np.asarray(js.code), np.asarray(js.x_forced), np.asarray(js.r0_b),
        np.asarray(js.b_norm), js.w, js.periodic, device="cpu")
    own = PP.ChebyshevPreconditioner.from_system(ps, **opts)
    assert torch.equal(own.diag, pm.diag) and torch.equal(own.free, pm.free)
    assert (own.degree, own.hi, own.ratio) == (pm.degree, pm.hi, pm.ratio)
    assert torch.equal(own(torch.from_numpy(r)), got)


@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_chebyshev_is_symmetric_positive(kind):
    """<u, M v> = <M u, v> and <u, M u> > 0: a valid CG preconditioner."""
    shape = (10, 8, 6)
    js, _, pm = _cheby_pair(kind, shape, (1.0, 1.0, 1.0), {"degree": 8})
    free = np.asarray(js.free)
    rng = np.random.default_rng(23)
    u = torch.from_numpy(np.where(free, rng.standard_normal(shape), 0.0))
    v = torch.from_numpy(np.where(free, rng.standard_normal(shape), 0.0))
    uMv, Muv = float(torch.sum(u * pm(v))), float(torch.sum(pm(u) * v))
    assert uMv == pytest.approx(Muv, rel=1e-10, abs=1e-12)
    assert float(torch.sum(u * pm(u))) > 0


def test_chebyshev_batch_equals_lanes():
    """A batch of systems through one object is each lane on its own."""
    rng = np.random.default_rng(24)
    B, shape = 3, (6, 5, 4)
    masks = torch.from_numpy(rng.random((B,) + shape) < 0.7)
    systems = PS.make_cell_problem_system(masks, 0, dtype=torch.float64)
    pm = PP.ChebyshevPreconditioner.from_system(systems, degree=12)
    r = torch.where(masks, torch.from_numpy(
        rng.standard_normal((B,) + shape)), 0.0)
    got = pm(r)
    for b in range(B):
        one = PP.ChebyshevPreconditioner.from_system(
            PS.make_cell_problem_system(masks[b], 0, dtype=torch.float64),
            degree=12)
        assert torch.equal(got[b], one(r[b]))


@pytest.mark.parametrize("name", ["cheby", "chebyshev"])
def test_make_precond_returns_chebyshev(name):
    js = _jax_system("flow", (8, 8, 8), 25, jnp.float64)
    ps = convert.system_from_numpy(
        np.asarray(js.code), np.asarray(js.x_forced), np.asarray(js.r0_b),
        np.asarray(js.b_norm), js.w, js.periodic, device="cpu")
    m = PRF.make_precond(ps, name, {"degree": 6, "ratio": 30.0})
    assert isinstance(m, PP.ChebyshevPreconditioner)
    assert (m.degree, m.hi, m.ratio) == (6, 2.0, 30.0)
    assert not hasattr(m, "use_xla")
    # a built preconditioner passes through: effective_diffusivity hands
    # one object to its three solves
    assert PRF.make_precond(ps, m) is m
