"""D_eff on X slabs, rehearsed on the CPU: the periodic slab reference
beside the one-device reference, and the D_eff kind on four gloo ranks
beside one rank."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from portbench import blobs, harness, traffic
from portbench.kinds import effective_diffusivity as kind
from portbench.reference import props, slab_cells, slabs

from conftest import small_cell
from test_bench_control import _altered

SEED = 2 ** 32 + 11
N = 48  # slabs of 12 planes on four: 12, 6, 3 down the cycle's levels


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_periodic_slab_reference_beside_the_one_device_reference(n_slabs):
    vol = blobs.blobs(N, 0.4, 12345, "cpu").numpy()
    ref, ref_infos = props.deff_tensor(torch.from_numpy(vol == 1))
    got, infos = slab_cells.deff_tensor(
        slabs.split(vol == 1, ("cpu",) * n_slabs))
    assert all(i.converged for i in infos)
    assert [i.iterations for i in infos] == [
        i.iterations for i in ref_infos]
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def _cell():
    return dataclasses.replace(
        small_cell("deff512.tensor", N, volumes=2), chips=4)


def test_four_ranks_answer_as_one_rank():
    """The window's tensors on X slabs over four ranks against the same
    requests on one rank, to well inside the package's 1e-9 residual."""
    import openimpala_tpu_torch as port

    kept = []

    def keep(*a, **k):  # rank 0's answers
        kept.append(port.effective_diffusivity(*a, **k))
        return kept[-1]

    cell = _cell()
    out = harness.run_cell(cell, SEED, 0.1, False, "cpu", 0.0,
                           port=types.SimpleNamespace(
                               effective_diffusivity=keep))
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    tr = traffic.make(cell.traffic, SEED)
    window = kept[len(tr.warmup(SEED)):]
    assert len(window) == out["attempted"] >= 1
    vols = [blobs.blobs(N, p, s, "cpu").numpy()
            for p, s in zip(tr.porosities, tr.volume_seeds)]
    for i, got in enumerate(window):
        req = tr.request(i, SEED)
        one = kind.call(port, vols[req.volume], req, cell.config, "cpu")
        assert round(got.volume_fraction * N ** 3) == round(
            one.volume_fraction * N ** 3)
        gap = np.abs(got.deff - one.deff).max() / np.abs(one.deff).max()
        assert gap <= 1e-8, (req.index, gap)


def test_altered_tensors_on_four_ranks_are_not_correct():
    import openimpala_tpu_torch as port

    broken = types.SimpleNamespace(effective_diffusivity=_altered(
        port.effective_diffusivity, 1 + 1e-5))
    out = harness.run_cell(_cell(), SEED, 0.1, False, "cpu", 0.0,
                           port=broken)
    assert not out["correct"], out["checks"]
