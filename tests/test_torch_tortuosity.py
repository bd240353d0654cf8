"""PyTorch port, the slice end to end: ``tortuosity(..., device="cpu")``
against ``openimpala_tpu.tortuosity(..., mesh=None)`` on the same volumes.

Tolerances: tau, deff and the boundary fluxes to 1e-6 relative (the golden
tolerance); ``flux_rel_diff`` is itself a relative flux mismatch at the
solver's noise level (~1e-9), so it is held to 1e-6 in absolute terms;
active_vf exactly; converged and flux_conserved equal; iterations within 2,
because the JAX package runs the bottom-form ``_cg_loop`` on the CPU while
the port always runs the top form, which gives the same iterates up to
rounding."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import openimpala_tpu as oi  # noqa: E402
import openimpala_tpu_torch as oit  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from make_sample_data import make_blobs  # noqa: E402


@pytest.fixture(scope="module")
def volumes(blob_phase):
    return {"blob": blob_phase, "blobs32": make_blobs(32, 0.4, seed=1)}


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("dx", [(1.0, 1.0, 1.0), (1.0, 1.0, 2.0)])
@pytest.mark.parametrize("direction", ["X", "Y", "Z"])
@pytest.mark.parametrize("name", ["blob", "blobs32"])
def test_tortuosity_matches_jax(volumes, name, direction, dx):
    vol = volumes[name]
    want = oi.tortuosity(vol, 1, direction, dx=dx, mesh=None)
    got = oit.tortuosity(vol, 1, direction, dx=dx, device="cpu")
    assert got.active_vf == want.active_vf
    assert got.converged == want.converged is True
    assert got.flux_conserved == want.flux_conserved is True
    assert got.direction == want.direction
    assert _rel(got.value, want.value) <= 1e-6
    assert _rel(got.deff, want.deff) <= 1e-6
    assert _rel(got.flux_in, want.flux_in) <= 1e-6
    assert _rel(got.flux_out, want.flux_out) <= 1e-6
    assert abs(got.flux_rel_diff - want.flux_rel_diff) <= 1e-6
    assert abs(got.iterations - want.iterations) <= 2
    assert got.rel_res <= 1e-9


def test_zero_percolation_gives_nan():
    phase = np.zeros((10, 10, 10), np.int32)
    phase[:, 4, 4] = 1
    phase[5, 4, 4] = 0  # the only channel is cut
    got = oit.tortuosity(phase, 1, "X", device="cpu")
    want = oi.tortuosity(phase, 1, "X", mesh=None)
    assert np.isnan(got.value) and np.isnan(want.value)
    assert got.active_vf == want.active_vf == 0.0
    assert not got.converged and got.iterations == 0


@pytest.mark.parametrize("shape,direction", [
    ((1, 20, 20), "X"), ((20, 1, 20), "Y"), ((20, 20, 1), "Z")])
def test_one_cell_thick_along_the_flow_matches_jax(shape, direction):
    """A volume one cell thick along the flow: both face planes are the
    same plane, so both face fluxes are 0 and tau is inf (the JAX package
    clamps the inner-plane index to the axis)."""
    phase = (np.random.default_rng(3).random(shape) < 0.8).astype(np.int32)
    want = oi.tortuosity(phase, 1, direction, mesh=None)
    got = oit.tortuosity(phase, 1, direction, device="cpu")
    assert got.value == want.value == np.inf
    assert got.deff == want.deff == 0.0
    assert got.active_vf == want.active_vf
    assert got.converged == want.converged is True
    assert got.flux_conserved == want.flux_conserved is True
    assert (got.flux_in, got.flux_out) == (want.flux_in, want.flux_out)
    assert got.iterations == want.iterations


def test_fields_history_and_timings(blob_phase):
    timings = {}
    got = oit.tortuosity(blob_phase, 1, "Z", device="cpu",
                         return_fields=True, return_history=True,
                         remspot_passes=1, timings=timings)
    want = oi.tortuosity(blob_phase, 1, "Z", mesh=None, remspot_passes=1)
    assert _rel(got.value, want.value) <= 1e-6
    assert got.phi.dtype == torch.float64 and got.phi.shape == blob_phase.shape
    np.testing.assert_array_equal(got.active, np.asarray(
        oit.ops.floodfill.percolation_mask(
            oit.ops.filters.remspot(torch.from_numpy(blob_phase), 1).numpy(),
            1, 2)[0]))
    assert got.history.outer and got.history.inner
    assert {"remspot", "percolation_mask", "system_setup", "solve",
            "flux"} <= set(timings)
