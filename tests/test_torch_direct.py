"""PyTorch port: the explicit baseline solver ``tortuosity_direct(...,
device="cpu")`` against ``openimpala_tpu.props.tortuosity_direct`` on the
same numpy volumes, in float64.

Tolerances: value, fluxes and residual to 1e-9 relative (both run the same
steps in float64; they differ by the order of the final sums); the step
counts equal.  The reference's quirks are held too: the full pore gives
-(N + 1) / N, ``vlo = 0`` blocks the inlet, and a run out of ``n_steps``
returns NaN, unconverged."""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from openimpala_tpu.props.tortuosity_direct import (  # noqa: E402
    tortuosity_direct as jax_direct)

import openimpala_tpu_torch as oit  # noqa: E402
# the module (``props.tortuosity_direct`` is the exported function)
td = importlib.import_module("openimpala_tpu_torch.props.tortuosity_direct")
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=1e-13):
    if math.isnan(want):
        return math.isnan(got)
    return abs(got - want) <= rtol * abs(want) + atol


def _both(vol, phase_id, direction, **kw):
    want = jax_direct(vol, phase_id, direction, **kw)
    got = oit.tortuosity_direct(vol, phase_id, direction, device="cpu",
                                **kw)
    return got, want


def _hold(got, want):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    for name in ("value", "flux_in", "flux_out", "residual"):
        assert _close(getattr(got, name), getattr(want, name)), \
            (name, getattr(got, name), getattr(want, name))


@pytest.fixture(scope="module")
def blobs16():
    return make_blobs(16, 0.6, 0)


def test_full_pore_is_minus_n_plus_one_over_n():
    vol = np.ones((10, 6, 6), np.int32)
    got, want = _both(vol, 1, "X")
    _hold(got, want)
    assert got.converged
    assert abs(got.value - (-(10 + 1) / 10)) <= 1e-6


@pytest.mark.parametrize("direction,dx,steps", [
    ("X", (1.0, 1.0, 1.0), 5151),
    ("Y", (1.0, 1.0, 2.0), None),
    ("Z", (2.0, 1.0, 1.0), None),
])
def test_blobs_match_jax(blobs16, direction, dx, steps):
    got, want = _both(blobs16, 1, direction, dx=dx)
    _hold(got, want)
    assert got.converged and got.value < 0  # the +d(phi)/dx sign quirk
    if steps is not None:
        assert got.iterations == steps
        assert _close(got.value, -2.145581311541298)


@pytest.mark.parametrize("case", ["full_pore", "blobs_3000_steps"])
def test_blocked_inlet_quirk(blobs16, case):
    """vlo = 0: the inlet ghost's cell type is nint(0) = blocked, so no
    flux enters and phi drifts to vhi.  On the blobs the run is cut at
    3000 steps: converged, the value divides by an outlet flux 1e-5 of its
    early size and no longer holds 1e-9 between two summation orders."""
    if case == "full_pore":
        got, want = _both(np.ones((10, 6, 6), np.int32), 1, "X", vlo=0.0,
                          vhi=1.0)
        assert got.converged
    else:
        got, want = _both(blobs16, 1, "X", vlo=0.0, vhi=1.0, n_steps=3000)
    _hold(got, want)
    assert got.flux_in == 0.0 and got.flux_out > 0


def test_out_of_steps_is_nan_unconverged(blobs16):
    got, want = _both(blobs16, 1, "X", n_steps=1000)
    _hold(got, want)
    assert not got.converged and math.isnan(got.value)
    assert got.iterations == 1010  # whole checks of plot_interval + 1


def test_fields_and_interval(blobs16):
    got, want = _both(blobs16, 1, "Z", plot_interval=37,
                      return_fields=True)
    _hold(got, want)
    np.testing.assert_allclose(got.phi.numpy(), np.asarray(want.phi),
                               rtol=RTOL, atol=1e-13)
    assert got.iterations % 38 == 0


def test_float32(blobs16):
    """float32 steps: both packages round each step on their own, so the
    check may land one interval apart."""
    import jax.numpy as jnp

    want = jax_direct(blobs16, 1, "X", eps=1e-3, dtype=jnp.float32)
    got = oit.tortuosity_direct(blobs16, 1, "X", eps=1e-3,
                                dtype=torch.float32, device="cpu")
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 101
    assert abs(got.value - want.value) <= 1e-4 * abs(want.value)


def test_ghost_pad_matches_jax():
    import jax.numpy as jnp

    jtd = importlib.import_module("openimpala_tpu.props.tortuosity_direct")
    rng = np.random.default_rng(3)
    phi = rng.random((5, 4, 3))
    ct = (rng.random((5, 4, 3)) < 0.6).astype(np.int8)
    for d in range(3):
        jp, jc = jtd._ghost_pad(jnp.asarray(phi), jnp.asarray(ct), d, -1.0,
                                1.0)
        tp, tc = td._ghost_pad(torch.from_numpy(phi), torch.from_numpy(ct),
                               d, -1.0, 1.0)
        # the faces and the interior; corners are never read
        for ax in range(3):
            sl = [slice(1, -1)] * 3
            sl[ax] = slice(None)
            np.testing.assert_array_equal(tp.numpy()[tuple(sl)],
                                          np.asarray(jp)[tuple(sl)])
            np.testing.assert_array_equal(tc.numpy()[tuple(sl)],
                                          np.asarray(jc)[tuple(sl)])


def test_exported():
    from openimpala_tpu_torch.props import (TortuosityDirectResult,
                                            tortuosity_direct)

    assert tortuosity_direct is oit.tortuosity_direct
    assert TortuosityDirectResult is oit.TortuosityDirectResult
