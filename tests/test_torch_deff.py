"""PyTorch port, the homogenisation path: ``deff_integrand_sum`` and
``check_operator_properties`` against the JAX package, then
``effective_diffusivity(..., device="cpu")`` (lockstep lanes under
``lanes="auto"`` at these sizes) against
``openimpala_tpu.effective_diffusivity(..., lanes=False, mesh=None)`` on the
same volumes, and ``tortuosity(precond="cheby")`` against the JAX one.

Tolerances: the integrand sums 1e-12 (the same differences in float64, the
sums taken in another order); the D_eff tensor 1e-6 absolute (its entries
are O(1) or smaller; the golden tolerance); iterations within 2 per
direction (the JAX package runs the bottom-form PCG on the CPU, the port
the top form) and within 1 under ``precond="sa"``; tau 1e-6 relative."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu.ops import flux as JF  # noqa: E402
from openimpala_tpu.ops import stencil as JS  # noqa: E402
from openimpala_tpu_torch.ops import flux as PF  # noqa: E402
from openimpala_tpu_torch.ops import stencil as PS  # noqa: E402
from openimpala_tpu_torch.props import effective_diffusivity as PED  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_sample_data import make_blobs  # noqa: E402


@pytest.mark.parametrize("dx", [(1.0, 1.0, 1.0), (1.0, 0.5, 2.0)])
def test_deff_integrand_sum_matches_jax(dx):
    rng = np.random.default_rng(31)
    shape = (9, 7, 6)
    active = rng.random(shape) < 0.6
    chis = [rng.standard_normal(shape) for _ in range(3)]
    want = np.asarray(JF.deff_integrand_sum(
        *(jnp.asarray(c) for c in chis), jnp.asarray(active), dx))
    got = PF.deff_integrand_sum(*(torch.from_numpy(c) for c in chis),
                                torch.from_numpy(active), dx)
    assert got.shape == (3, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # a batch is its lanes one by one
    stack = [torch.from_numpy(np.stack([c, -2.0 * c])) for c in chis]
    masks = torch.from_numpy(np.stack([active, ~active]))
    both = PF.deff_integrand_sum(*stack, masks, dx)
    assert both.shape == (2, 3, 3)
    np.testing.assert_allclose(both[0].numpy(), want, rtol=1e-12, atol=1e-12)
    want1 = np.asarray(JF.deff_integrand_sum(
        *(jnp.asarray(-2.0 * c) for c in chis), jnp.asarray(~active), dx))
    np.testing.assert_allclose(both[1].numpy(), want1, rtol=1e-12,
                               atol=1e-12)
    # deff_tensor divides by the TOTAL cell count
    np.testing.assert_allclose(
        PED.deff_tensor(*(torch.from_numpy(c) for c in chis),
                        torch.from_numpy(active), dx).numpy(),
        want / active.size, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind,dx", [("flow", (1.0, 1.0, 1.0)),
                                     ("flow", (1.0, 0.5, 2.0)),
                                     ("cell", (1.0, 1.0, 1.0))])
def test_check_operator_properties_matches_jax(kind, dx):
    active = np.random.default_rng(32).random((10, 8, 6)) < 0.7
    if kind == "flow":
        js = JS.make_tortuosity_system(jnp.asarray(active), 0, -1.0, 1.0,
                                       dx=dx)
        ps = PS.make_tortuosity_system(torch.from_numpy(active), 0, -1.0,
                                       1.0, dx=dx)
    else:
        js = JS.make_cell_problem_system(jnp.asarray(active), 2, dx=dx)
        ps = PS.make_cell_problem_system(torch.from_numpy(active), 2, dx=dx)
    want = JS.check_operator_properties(js, jnp.asarray(active))
    got = PS.check_operator_properties(ps, torch.from_numpy(active))
    assert set(got) == set(want)
    np.testing.assert_allclose(got.pop("row_sum").numpy(),
                               np.asarray(want.pop("row_sum")), rtol=1e-12,
                               atol=1e-12)
    assert got == want
    assert got["finite"] and got["diag_positive_on_free"]


@pytest.fixture(scope="module")
def volumes(blob_phase):
    return {"blob": blob_phase, "blobs24": make_blobs(24, 0.5, seed=2),
            "blobs32": make_blobs(32, 0.4, seed=1)}


@pytest.mark.parametrize("name,dx", [
    ("blob", (1.0, 1.0, 1.0)),
    ("blobs24", (1.0, 1.0, 1.0)),
    ("blobs24", (1.0, 1.0, 2.0)),
    ("blobs32", (1.0, 1.0, 1.0)),
])
def test_effective_diffusivity_matches_jax(volumes, name, dx):
    vol = volumes[name]
    want = oi.effective_diffusivity(vol, 1, dx=dx, lanes=False, mesh=None)
    timings = {}
    got = oit.effective_diffusivity(vol, 1, dx=dx, device="cpu",
                                    timings=timings)
    assert got.converged and want.converged
    assert got.volume_fraction == want.volume_fraction
    assert got.deff.shape == (3, 3) and np.isfinite(got.deff).all()
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.deff, got.deff.T, rtol=0, atol=1e-8)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 2
    assert max(got.rel_res) <= 1e-9
    assert got.chi is None and got.history is None
    assert {"mask_upload", "system_setup", "hierarchy_build", "solve",
            "deff_tensor"} <= set(timings)


def test_effective_diffusivity_cheby_fields_and_history(volumes):
    """The same tensor through the Chebyshev preconditioner, built once and
    shared by the three solves; fields and histories on request."""
    vol = volumes["blob"]
    want = oi.effective_diffusivity(vol, 1, precond="cheby", lanes=False,
                                    mesh=None)
    got = oit.effective_diffusivity(vol, 1, precond="cheby", device="cpu",
                                    return_fields=True, return_history=True,
                                    lanes=False)
    assert got.converged and want.converged
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 2
    assert len(got.chi) == 3 and len(got.history) == 3
    for chi, hist in zip(got.chi, got.history):
        assert chi.shape == vol.shape and chi.dtype == torch.float64
        assert hist.outer and hist.inner
    # the fields reproduce the tensor
    np.testing.assert_allclose(
        PED.deff_tensor(*got.chi, torch.from_numpy(vol == 1)).numpy(),
        got.deff, rtol=0, atol=1e-14)


def test_zero_active_shortcut():
    vol = np.zeros((8, 8, 8), np.int32)
    want = oi.effective_diffusivity(vol, 1, lanes=False, mesh=None)
    got = oit.effective_diffusivity(vol, 1, device="cpu", return_fields=True)
    assert got.converged and want.converged
    assert got.iterations == want.iterations == (0, 0, 0)
    assert got.rel_res == want.rel_res == (0.0, 0.0, 0.0)
    assert got.volume_fraction == want.volume_fraction == 0.0
    np.testing.assert_array_equal(got.deff, np.asarray(want.deff))
    assert all(float(c.abs().max()) == 0.0 for c in got.chi)


def test_nan_tensor_when_a_solve_fails(blob_phase):
    """Two iterations cannot reach 1e-9: not converged, NaN tensor, as in
    the JAX package."""
    want = oi.effective_diffusivity(blob_phase, 1, maxiter=2,
                                    precond="jacobi", lanes=False, mesh=None)
    got = oit.effective_diffusivity(blob_phase, 1, maxiter=2,
                                    precond="jacobi", device="cpu")
    assert not got.converged and not want.converged
    assert np.isnan(got.deff).all() and np.isnan(np.asarray(want.deff)).all()
    assert got.volume_fraction == want.volume_fraction


def test_lanes_true_matches_jax_lanes(blob_phase):
    """``lanes=True`` runs the three cell problems as lockstep lanes: the
    same tensor as the JAX package's lanes (1e-6, iterations within 2) and
    as the port's sequential loop (1e-9); where lanes cannot run it
    raises."""
    want = oi.effective_diffusivity(blob_phase, 1, lanes=True, mesh=None)
    got = oit.effective_diffusivity(blob_phase, 1, lanes=True, device="cpu")
    seq = oit.effective_diffusivity(blob_phase, 1, lanes=False, device="cpu")
    assert got.converged and want.converged and seq.converged
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.deff, seq.deff, rtol=0, atol=1e-9)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 2
    with pytest.raises(ValueError, match="lanes=True"):
        oit.effective_diffusivity(blob_phase, 1, lanes=True, device="cpu",
                                  inner_dtype=None)


def test_effective_diffusivity_sa_periodic_18(volumes):
    """``precond="sa"`` reaches a periodic smoothed-aggregation build.  On
    an 18^3 volume the probe spacing (6) divides the fine extent but not the
    coarse one (9), so level 1 is not the Galerkin product; the port keeps
    the reference's spacing, and the two packages agree there."""
    vol = make_blobs(18, 0.5, seed=3)
    want = oi.effective_diffusivity(vol, 1, precond="sa", lanes=False,
                                    mesh=None)
    got = oit.effective_diffusivity(vol, 1, precond="sa", device="cpu")
    assert got.converged and want.converged
    np.testing.assert_allclose(got.deff, np.asarray(want.deff), rtol=0,
                               atol=1e-6)
    for g, w in zip(got.iterations, want.iterations):
        assert abs(g - w) <= 1


@pytest.mark.parametrize("name", ["cheby", "chebyshev"])
def test_tortuosity_cheby_matches_jax(volumes, name):
    vol = volumes["blob"]
    want = oi.tortuosity(vol, 1, "X", precond=name, mesh=None)
    got = oit.tortuosity(vol, 1, "X", precond=name, device="cpu")
    assert got.converged and want.converged
    assert got.flux_conserved and want.flux_conserved
    assert got.active_vf == want.active_vf
    assert abs(got.value - want.value) <= 1e-6 * abs(want.value)
    assert abs(got.iterations - want.iterations) <= 2
