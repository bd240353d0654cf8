"""PyTorch port, ``ops/offset.py``: the packing order and the plain forms of
kernel K3 (apply, the nearest-neighbour prefix, resid, sweep) against the
JAX package on the same inputs: ``OffsetLevel``'s roll forms in float64
(1e-12) and ``offset_stencil_pallas`` in interpret mode at (8, 16, 128) in
float32 (2e-5: another summation order and FMA contraction), with float32
and bfloat16 packed coefficients."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from openimpala_tpu.ops import offset_pallas as JO  # noqa: E402
from openimpala_tpu.solve import sa as JSA  # noqa: E402
from openimpala_tpu_torch import convert  # noqa: E402
from openimpala_tpu_torch.ops import offset as PO  # noqa: E402
from openimpala_tpu_torch.ops import offset_cuda  # noqa: E402
from openimpala_tpu_torch.solve import sa as PSA  # noqa: E402

TOL64 = dict(rtol=1e-12, atol=1e-12)
TOL32 = dict(rtol=2e-5, atol=2e-5)


def _support(taps):
    """33 taps: the l_inf<=1 ball and the axial +-2 taps (the level-1
    support); 125 taps: every offset of [-2, 2]^3 (the level-2 support)."""
    if taps == 125:
        r = range(-2, 3)
        return tuple((i, j, k) for i in r for j in r for k in r)
    r = (-1, 0, 1)
    return tuple(sorted(set(
        [(i, j, k) for i in r for j in r for k in r]
        + [(2, 0, 0), (-2, 0, 0), (0, 2, 0), (0, -2, 0), (0, 0, 2),
           (0, 0, -2)])))[:taps]


def _coeffs(rng, shape, sup):
    """Random coefficients; the diagonal has exact zeros (mask coverage) and
    stays away from (0, 0.3), where omega/d would amplify rounding."""
    out = []
    for o in sup:
        c = rng.standard_normal(shape)
        if o == (0, 0, 0):
            c = np.where(np.abs(c) < 0.3, 0.0, 3.0 * c)
        out.append(c)
    return out


def _levels(rng, shape, taps, np_dtype, packed_dtype=None):
    """The same synthetic level as a JAX and a port OffsetLevel."""
    sup = _support(taps)
    cs = _coeffs(rng, shape, sup)
    jl = JSA.OffsetLevel.from_coeffs(
        tuple(jnp.asarray(c, np_dtype) for c in cs), sup)
    if packed_dtype is not None:
        jl = JSA.OffsetLevel(packed=jl.packed.astype(packed_dtype),
                             offsets=jl.offsets, nn=jl.nn)
    pl = convert.offset_level_from_numpy(np.asarray(jl.packed), jl.offsets,
                                         jl.nn, device="cpu")
    return jl, pl


@pytest.mark.parametrize("sup", [
    _support(33), _support(125), _support(20),
    ((1, 0, 0), (0, 0, 2), (-1, 1, 0)),  # no centre tap
    tuple(reversed(_support(33))),
])
def test_order_offsets_matches_jax(sup):
    assert PO.order_offsets(sup) == JO.order_offsets(sup)
    ordered, nn = PO.order_offsets(sup)
    assert sorted(ordered) == sorted(sup)
    assert all(max(abs(c) for c in o) <= 1 for o in ordered[:nn])
    assert all(max(abs(c) for c in o) > 1 for o in ordered[nn:])


def test_from_coeffs_packs_like_jax():
    rng = np.random.default_rng(0)
    shape = (5, 4, 6)
    sup = _support(33)
    cs = _coeffs(rng, shape, sup)
    jl = JSA.OffsetLevel.from_coeffs(tuple(jnp.asarray(c) for c in cs), sup)
    pl = PSA.OffsetLevel.from_coeffs([torch.from_numpy(c) for c in cs], sup)
    assert (pl.offsets, pl.nn) == (jl.offsets, jl.nn)
    assert pl.packed.is_contiguous()
    np.testing.assert_array_equal(pl.packed.numpy(), np.asarray(jl.packed))
    np.testing.assert_array_equal(pl.diag.numpy(), np.asarray(jl.diag))
    np.testing.assert_array_equal(pl.free.numpy(), np.asarray(jl.free))
    for a, b in zip(pl.coeffs, jl.coeffs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape,taps", [
    ((9, 6, 7), 33), ((4, 4, 4), 125), ((2, 1, 3), 33),
])
@pytest.mark.parametrize("mode", ["apply", "apply_sub", "resid", "sweep"])
def test_plain_forms_match_jax_roll_forms_f64(mode, shape, taps):
    """Extents below the stencil's reach included: every read wraps."""
    rng = np.random.default_rng(1)
    jl, pl = _levels(rng, shape, taps, np.float64)
    x = rng.standard_normal(shape)
    r = rng.standard_normal(shape)
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    jx, jr = jnp.asarray(x), jnp.asarray(r)
    if mode == "apply":
        got, want = pl.apply(tx), jl.apply_xla(jx)
    elif mode == "apply_sub":
        keep = JSA._nn_filter(jl.offsets)
        got, want = pl.apply_nn(tx), jl.apply_sub(jx, keep)
    elif mode == "resid":
        got, want = pl.resid(tx, tr), jl.resid(jx, jr)
    else:
        got, want = pl.sweep(tx, tr, 0.9), jl.sweep(jx, jr, 0.9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL64)


@pytest.mark.parametrize("packed_dtype", [None, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["apply", "prefix", "resid", "sweep"])
def test_plain_forms_match_pallas_interpret_f32(mode, packed_dtype):
    shape = (8, 16, 128)
    rng = np.random.default_rng(2)
    jl, pl = _levels(rng, shape, 33, np.float32, packed_dtype)
    assert pl.packed.dtype == (torch.float32 if packed_dtype is None
                               else torch.bfloat16)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    tx, tr = torch.from_numpy(x), torch.from_numpy(r)
    kw = dict(mode="apply" if mode == "prefix" else mode, omega=0.9,
              interpret=True)
    if mode == "prefix":
        kw["n_taps"] = jl.nn
    if mode in ("resid", "sweep"):
        kw["r"] = jnp.asarray(r)
    want = JO.offset_stencil_pallas(jnp.asarray(x), jl.packed, jl.offsets,
                                    **kw)
    got = {"apply": lambda: PO.offset_apply(tx, pl.packed, pl.offsets),
           "prefix": lambda: PO.offset_apply(tx, pl.packed, pl.offsets,
                                             n_taps=pl.nn),
           "resid": lambda: PO.offset_resid(tx, tr, pl.packed, pl.offsets),
           "sweep": lambda: PO.offset_sweep(tx, tr, pl.packed, pl.offsets,
                                            0.9)}[mode]()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_apply_nn_takes_the_prefix_only():
    rng = np.random.default_rng(3)
    _, pl = _levels(rng, (4, 4, 4), 33, np.float64)
    assert pl.nn == 27 < len(pl.offsets)
    x = torch.from_numpy(rng.standard_normal((4, 4, 4)))
    torch.testing.assert_close(
        pl.apply_nn(x),
        PO.offset_apply_plain(x, pl.packed, pl.offsets, n_taps=pl.nn))
    wide = PO.offset_apply_plain(x, pl.packed[:, pl.nn:].contiguous(),
                                 pl.offsets[pl.nn:])
    torch.testing.assert_close(pl.apply_nn(x) + wide, pl.apply(x))


@pytest.mark.parametrize("mode", ["apply", "resid", "sweep"])
def test_k3_launcher_refuses_cpu_tensors(mode):
    """The kernel wrapper never falls back: a CPU tensor raises."""
    rng = np.random.default_rng(4)
    _, pl = _levels(rng, (4, 4, 4), 33, np.float32)
    x = torch.zeros((4, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        offset_cuda.k3_offset(mode, x, x, pl.packed, pl.offsets)
    with pytest.raises(ValueError, match="unknown K3 mode"):
        offset_cuda.k3_offset("matvec", x, x, pl.packed, pl.offsets)


def test_k3_bound_arithmetic():
    """Compulsory bytes per cell: the taps' coefficients, x once, out once,
    r for resid and sweep; 2 flops per tap."""
    cost = offset_cuda.k3_cost
    assert cost("k3_apply_f32", 33, 4, 4) == (140, 66)
    assert cost("k3_apply_prefix_f32", 27, 4, 4) == (116, 54)
    assert cost("k3_resid_f32", 33, 4, 4) == (144, 66)
    assert cost("k3_sweep_f32", 125, 2, 4) == (262, 250)
    assert cost("k3_sweep_f64", 125, 8, 8) == (1024, 250)
    # a 33-tap float32 apply at 256^3: 2.35 GB, 0.70 ms at 3.35 TB/s
    ms = 140 * 256 ** 3 / 3.35e12 * 1e3
    assert ms == pytest.approx(0.7011, abs=1e-4)
