"""PyTorch port, ``ops/stencil.py``: packed geometry bit-exact against the
JAX package, and the operator and the four K1 modes (the plain forms the
kernel is held against) at 1e-12 in float64, for both operators and both
spacings.  The fused restriction is also held against the JAX Pallas
kernel itself, run in interpret mode as ``tests/test_pallas.py`` does."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import stencil as J  # noqa: E402
from openimpala_tpu_torch.ops import stencil as P  # noqa: E402

SHAPE = (12, 10, 8)
DXS = [(1.0, 1.0, 1.0), (1.0, 0.5, 2.0)]
TOL = dict(rtol=1e-12, atol=1e-12)


def _mask(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).random(shape) < 0.7


def _bits(code_j, code_p):
    return (np.asarray(code_j).view(np.uint16),
            code_p.view(torch.int16).numpy().view(np.uint16))


def _systems(kind, dx, direction=0, dtype=(jnp.float64, torch.float64),
             shape=SHAPE):
    mask = _mask(direction + 3 * (dx[1] != 1.0), shape)
    if kind == "flow":
        js = J.make_tortuosity_system(jnp.asarray(mask), direction, -1.0, 1.0,
                                      dx=dx, dtype=dtype[0])
        ps = P.make_tortuosity_system(torch.from_numpy(mask), direction, -1.0,
                                      1.0, dx=dx, dtype=dtype[1])
    else:
        js = J.make_cell_problem_system(jnp.asarray(mask), direction, dx=dx,
                                        dtype=dtype[0])
        ps = P.make_cell_problem_system(torch.from_numpy(mask), direction,
                                        dx=dx, dtype=dtype[1])
    return js, ps


def _fields(ps, seed, np_dtype=np.float64):
    rng = np.random.default_rng(seed)
    free = ps.free.numpy()
    shape = tuple(ps.code.shape)
    x = np.where(free, rng.standard_normal(shape), 0.0).astype(np_dtype)
    r = np.where(free, rng.standard_normal(shape), 0.0).astype(np_dtype)
    return x, r


def test_neighbor_counts_and_packing_bit_exact():
    mask = _mask(1)
    for periodic in [(False,) * 3, (True,) * 3, (True, False, True)]:
        ja = J.neighbor_count_axes(jnp.asarray(mask), periodic)
        pa = P.neighbor_count_axes(torch.from_numpy(mask), periodic)
        for a, b in zip(ja, pa):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        free = mask & (np.asarray(ja[0]) > 0)
        for w in [(1.0,) * 3, (1.0, 4.0, 0.25)]:
            cj = J.pack_code_for(w, jnp.asarray(mask), jnp.asarray(free),
                                 periodic)
            cp = P.pack_code_for(w, torch.from_numpy(mask),
                                 torch.from_numpy(free), periodic)
            np.testing.assert_array_equal(*_bits(cj, cp))
        np.testing.assert_array_equal(
            P.weighted_degree(torch.from_numpy(mask), (1.0, 4.0, 0.25),
                              periodic, torch.float64).numpy(),
            np.asarray(J.weighted_degree(jnp.asarray(mask), (1.0, 4.0, 0.25),
                                         periodic, jnp.float64)))


@pytest.mark.parametrize("dx", DXS)
@pytest.mark.parametrize("direction", [0, 1, 2])
@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_system_build_matches_jax(kind, direction, dx):
    js, ps = _systems(kind, dx, direction)
    np.testing.assert_array_equal(*_bits(js.code, ps.code))
    np.testing.assert_array_equal(ps.free.numpy(), np.asarray(js.free))
    assert ps.w == js.w and ps.periodic == js.periodic
    for dt_j, dt_p in ((jnp.float64, torch.float64),
                       (jnp.float32, torch.float32)):
        dj, fj = J.decode_code(js.code, js.w, dt_j)
        dp, fp = P.decode_code(ps.code, ps.w, dt_p)
        np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    if not js.w[0] == js.w[1] == js.w[2]:
        for a, b in zip(J.unpack_code_axes(js.code, jnp.float32),
                        P.unpack_code_axes(ps.code, torch.float32)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in ((js.x_forced, ps.x_forced), (js.r0_b, ps.r0_b),
                 (js.b_norm, ps.b_norm)):
        assert tuple(b.shape) == tuple(np.shape(a))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_isolated_cell_decoupled_before_dirichlet():
    mask = np.zeros((6, 5, 5), bool)
    mask[0, 2, 2] = True  # isolated inlet-plane cell: identity row, rhs 0
    mask[:, 0, 0] = True  # a connected channel
    js = J.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0)
    ps = P.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0)
    assert float(ps.x_forced[0, 2, 2]) == 0.0
    np.testing.assert_array_equal(ps.x_forced.numpy(),
                                  np.asarray(js.x_forced))
    ph = P.make_tortuosity_system(torch.from_numpy(mask), 0, -1.0, 1.0,
                                  hi_plane=3)
    jh = J.make_tortuosity_system(jnp.asarray(mask), 0, -1.0, 1.0,
                                  hi_plane=3)
    np.testing.assert_array_equal(*_bits(jh.code, ph.code))
    np.testing.assert_array_equal(ph.x_forced.numpy(), np.asarray(jh.x_forced))


@pytest.mark.parametrize("dx", DXS)
@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_k1_modes_plain_match_jax_f64(kind, dx):
    js, ps = _systems(kind, dx, direction=1)
    x, r = _fields(ps, 7)
    xj, rj, xp, rp = jnp.asarray(x), jnp.asarray(r), torch.from_numpy(x), \
        torch.from_numpy(r)
    W, PER = js.w, js.periodic

    np.testing.assert_allclose(ps.apply(xp).numpy(),
                               np.asarray(js.apply(xj)), **TOL)
    axp, dotp = ps.apply_with_dot(xp)
    axj, dotj = js.apply_with_dot(xj)
    np.testing.assert_allclose(axp.numpy(), np.asarray(axj), **TOL)
    np.testing.assert_allclose(float(dotp), float(dotj), rtol=1e-12)
    np.testing.assert_allclose(
        P.residual_restricted(xp, rp, ps.code, W, PER).numpy(),
        np.asarray(J.residual_restricted(xj, rj, js.code, W, PER)), **TOL)
    np.testing.assert_allclose(
        P.smooth_sweep(xp, rp, ps.code, W, PER, 0.9).numpy(),
        np.asarray(J.smooth_sweep(xj, rj, js.code, W, PER, 0.9)), **TOL)
    np.testing.assert_allclose(
        P.residual_restrict(xp, rp, ps.code, W, PER).numpy(),
        np.asarray(J.residual_restrict(xj, rj, js.code, W, PER)), **TOL)
    dj, fj = J.decode_code(js.code, W, jnp.float64)
    np.testing.assert_allclose(
        P.apply_restricted(xp, ps.diag, ps.free, W, PER).numpy(),
        np.asarray(J.apply_restricted_xla(xj, dj, fj, W, PER)), **TOL)
    np.testing.assert_allclose(
        P.neighbor_sum(xp, W, PER).numpy(),
        np.asarray(J.neighbor_sum(xj, W, PER)), **TOL)


@pytest.mark.parametrize("dx", DXS)
@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_system_methods_match_jax_f64(kind, dx):
    js, ps = _systems(kind, dx, direction=2)
    x, _ = _fields(ps, 11)
    np.testing.assert_allclose(
        ps.initial_residual(torch.from_numpy(x)).numpy(),
        np.asarray(js.initial_residual(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        ps.assemble_solution(torch.from_numpy(x)).numpy(),
        np.asarray(js.assemble_solution(jnp.asarray(x))), **TOL)
    p32, j32 = ps.astype(torch.float32), js.astype(jnp.float32)
    assert p32.r0_b.dtype == torch.float32 and p32.code is ps.code
    np.testing.assert_array_equal(p32.x_forced.numpy(),
                                  np.asarray(j32.x_forced))
    np.testing.assert_array_equal(p32.diag.numpy(), np.asarray(j32.diag))


@pytest.mark.parametrize("kind", ["flow", "cell"])
def test_restrict_matches_pallas_interpret(kind):
    """The fused resid+restriction against the JAX Pallas kernel (interpret
    mode) in float32."""
    from openimpala_tpu.ops.stencil_pallas import fused_stencil_pallas

    shape = (8, 16, 128)
    js, ps = _systems(kind, (1.0, 1.0, 1.0), 0,
                      dtype=(jnp.float32, torch.float32), shape=shape)
    x, r = _fields(ps, 13, np.float32)
    want = np.asarray(fused_stencil_pallas(
        "restrict", jnp.asarray(x), jnp.asarray(r), js.code, js.w,
        js.periodic, interpret=True))
    got = P.residual_restrict(torch.from_numpy(x), torch.from_numpy(r),
                              ps.code, ps.w, ps.periodic).numpy()
    assert got.shape == (4, 8, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
