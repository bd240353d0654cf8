"""The plain reference on cases with a known answer, and beside the
package on small volumes of the cells' recipe."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import laplace, props


@pytest.mark.parametrize("n", [6, 12, 33])
def test_open_channel_tau_is_the_discrete_one(n):
    """An all-pore box: the Dirichlet planes sit on cell centres, so the
    potential falls over n - 1 spacings of a length n, and the discrete tau
    is (n - 1) / n (1 in the limit)."""
    ok = torch.ones((n, 7, 5), dtype=torch.bool)
    active, n_active = props.percolation(ok, 0)
    assert n_active == ok.numel()
    r = props.tortuosity(active, n_active, 0)
    assert r["converged"] and r["flux_conserved"]
    assert r["tau"] == pytest.approx((n - 1) / n, rel=1e-10)


def test_straight_channels_carry_the_flow_alone():
    phase = torch.zeros((10, 6, 6), dtype=torch.bool)
    phase[:, 1, 1] = True
    phase[:, 4, 3] = True
    phase[:4, 3, 5] = True  # a dead end: not percolating
    active, n_active = props.percolation(phase, 0)
    assert n_active == 20
    r = props.tortuosity(active, n_active, 0)
    assert r["tau"] == pytest.approx(9 / 10, rel=1e-10)
    assert r["active_vf"] == pytest.approx(20 / phase.numel())


def test_a_blocked_volume_does_not_percolate():
    phase = torch.zeros((8, 8, 8), dtype=torch.bool)
    phase[:3] = True
    assert props.percolation(phase, 0)[1] == 0
    assert props.percolation(phase, 1)[1] == 3 * 64


@pytest.mark.parametrize("shape", [(8, 8, 8), (6, 10, 4)])
def test_all_pore_cube_has_identity_tensor(shape):
    d, infos = props.deff_tensor(torch.ones(shape, dtype=torch.bool))
    np.testing.assert_allclose(d, np.eye(3), atol=1e-14)
    assert all(i.converged for i in infos)


def test_straight_channel_tensor_is_its_volume_fraction():
    phase = torch.zeros((8, 6, 6), dtype=torch.bool)
    phase[:, 2, 2] = True
    d, _ = props.deff_tensor(phase)
    vf = 8 / phase.numel()
    np.testing.assert_allclose(np.diag(d), [vf, vf, vf], rtol=1e-10)


def test_the_cycle_is_symmetric():
    """CG needs a symmetric preconditioner: <M u, v> = <u, M v>."""
    g = torch.Generator().manual_seed(3)
    ok = torch.rand((16, 16, 16), generator=g) < 0.7
    op = props.cell_operator(ok)
    mg = laplace.Multigrid.build(op, min_extent=2)
    assert len(mg.levels) == 4
    u, v = (torch.where(ok, torch.randn(ok.shape, generator=g,
                                        dtype=torch.float64), 0.0)
            for _ in range(2))
    a, b = torch.dot(mg(u).flatten(), v.flatten()), torch.dot(
        u.flatten(), mg(v).flatten())
    assert float(a) == pytest.approx(float(b), rel=1e-12)


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_reference_beside_the_package_on_blobs(direction):
    """At 40^3 on the CPU both agree to well inside the package's 1e-9
    residual; the active cells exactly."""
    from openimpala_tpu_torch import tortuosity

    from portbench.blobs import blobs

    vol = blobs(40, 0.4, 12345, "cpu").numpy()
    ok = torch.from_numpy(vol == 1)
    active, n_active = props.percolation(ok, direction)
    ref = props.tortuosity(active, n_active, direction)
    got = tortuosity(vol, 1, direction, device="cpu")
    assert round(got.active_vf * vol.size) == n_active
    assert got.value == pytest.approx(ref["tau"], rel=1e-8)
    assert got.flux_in == pytest.approx(ref["flux_in"], rel=1e-8)
    assert math.isfinite(ref["tau"]) and ref["rel_res"] <= props.TOL


def test_reference_tensor_beside_the_package():
    from openimpala_tpu_torch import effective_diffusivity

    from portbench.blobs import blobs

    vol = blobs(32, 0.4, 99, "cpu").numpy()
    ref, _ = props.deff_tensor(torch.from_numpy(vol == 1))
    got = effective_diffusivity(vol, 1, device="cpu").deff
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()
