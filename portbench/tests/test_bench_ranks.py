"""A cell on several cards, rehearsed on the CPU: the plain reference on
X slabs beside the one-device reference, and the harness on four gloo
ranks beside one rank, with a rank killed in the window."""

import math
import time

import pytest
import torch

from portbench import blobs, harness, ranks, traffic
from portbench.kinds import tortuosity as kind
from portbench.reference import props, slabs
from portbench.tests import slab_ports

from conftest import small_cell

SEED = 2 ** 32 + 11
N = 48  # slabs of 12 planes: 12, 6, 3 down the cycle's three levels


@pytest.mark.parametrize("direction", [0, 1, 2])
def test_slab_reference_beside_the_one_device_reference(direction):
    vol = blobs.blobs(N, 0.4, 12345, "cpu").numpy()
    ok = torch.from_numpy(vol == 1)
    active, n_active = props.percolation(ok, direction)
    ref = props.tortuosity(active, n_active, direction)
    parts, n_slab = slabs.percolation(slabs.split(vol == 1, ("cpu",) * 4),
                                      direction)
    got = slabs.tortuosity(parts, n_slab, direction)
    assert n_slab == n_active and torch.equal(torch.cat(parts), active)
    assert got["converged"] and math.isfinite(got["tau"])
    for k in ("tau", "flux_in", "flux_out"):
        assert abs(got[k] - ref[k]) <= 1e-12 * abs(ref[k]), k


def _cell():
    return small_cell("tau1024.slabs4", N, volumes=2, porosity=0.4)


def test_four_ranks_answer_as_one_rank():
    """The window's answers on X slabs over four ranks against the same
    requests on one rank: the active cells exactly, tau and the fluxes to
    well inside the package's 1e-9 residual."""
    import openimpala_tpu_torch as port

    cell = _cell()
    slab_ports.ANSWERS.clear()
    out = harness.run_cell(cell, SEED, 3.0, False, "cpu", 0.0,
                           port="portbench.tests.slab_ports:recorded")
    assert out["correct"], out["checks"]
    tr = traffic.make(cell.traffic, SEED)
    window = slab_ports.ANSWERS[len(tr.warmup(SEED)):]  # rank 0's
    assert out["device"]["count"] == 4
    assert len(window) == out["attempted"] >= 2
    vols = [blobs.blobs(N, p, s, "cpu").numpy()
            for p, s in zip(tr.porosities, tr.volume_seeds)]
    for i, (direction, got) in enumerate(window):
        req = tr.request(i, SEED)
        assert direction == req.direction
        one = kind.call(port, vols[req.volume], req, cell.config, "cpu")
        assert round(got.active_vf * N ** 3) == round(one.active_vf * N ** 3)
        for k in ("value", "flux_in", "flux_out"):
            a, b = getattr(got, k), getattr(one, k)
            assert abs(a - b) <= 1e-8 * abs(b), (req.index, k, a, b)


def test_a_rank_killed_in_the_window_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 exited with code -9"):
        harness.run_cell(_cell(), SEED, 10.0, False, "cpu", 0.0,
                         port="portbench.tests.slab_ports:killed")
    assert time.monotonic() - t0 < ranks.TIMEOUT_S


def test_a_traced_run_on_ranks_reads_the_slab_metrics():
    out = harness.run_cell(_cell(), SEED, 0.1, True, "cpu", 0.0)
    assert out["correct"], out["checks"]
    for name in ("props.percolation_ms.slabs4", "props.solve_ms.slabs4",
                 "solve.iterations.slabs4", "solve.ms_per_step.slabs4",
                 "parallel.exchanges_per_step.slabs4",
                 "parallel.exchange_mb.slabs4"):
        assert out["metrics"][name]["value"] > 0, name
