"""The CLI cell (``kinds/cli.py``): the benchmark's TIFF writer against the
package's reader, the harness's ``prepare`` hook, and runs whose CLI is
broken underneath failing the comparison, on the CPU at a small size with
the cell's own limits (its control and a sound run:
``test_bench_control.py``)."""

import dataclasses
import os

import numpy as np
import pytest

from portbench import harness
from portbench.kinds import cli

from conftest import small_cell
from test_bench_control import _unchanged_state

SEED = 2 ** 32 + 11
NAME = "cli512.xyz"


def _cell():
    return small_cell(NAME, 32, volumes=2)


@pytest.mark.parametrize("shape", [(24, 20, 17), (19, 20, 17)])
def test_the_tiff_writer_round_trips_through_the_package_reader(shape,
                                                                tmp_path):
    """Axis order, and rows whose bits do not fill their last byte."""
    from openimpala_tpu_torch.io.tiff import TiffReader

    volume = np.random.default_rng(3).integers(0, 2, shape, dtype=np.uint8)
    path = str(tmp_path / "stack.tif")
    cli.write_tiff1(path, volume)
    assert os.path.getsize(path) < volume.size // 8 + 4096
    reader = TiffReader(path)
    assert (reader.width, reader.height, reader.depth) == shape
    assert reader.bits_per_sample == 1
    got = reader.read()
    assert got.shape == shape and (got == volume.astype(bool)).all()
    assert (reader.threshold(0.5) == volume).all()


def test_the_tiff_writer_refuses_more_than_two_values(tmp_path):
    with pytest.raises(ValueError):
        cli.write_tiff1(str(tmp_path / "stack.tif"),
                        np.full((8, 8, 2), 2, np.uint8))


def test_prepare_runs_once_before_the_warm_up_outside_the_window(
        monkeypatch):
    events = []
    prepare, call = cli.prepare, cli.call

    def prepare_spy(volumes, config, traffic, workdir):
        feed = prepare(volumes, config, traffic, workdir)
        events.append(("prepare", workdir, harness.time.perf_counter()))
        return feed

    def call_spy(port, inputs, request, *a, **k):
        assert os.path.exists(inputs)
        events.append(("call", request.index, harness.time.perf_counter()))
        return call(port, inputs, request, *a, **k)

    monkeypatch.setattr(cli, "prepare", prepare_spy)
    monkeypatch.setattr(cli, "call", call_spy)
    out = harness.run_cell(_cell(), SEED, 0.1, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert [e[0] for e in events].count("prepare") == 1
    assert events[0][0] == "prepare" and events[1][:2] == ("call", -1)
    # t0 = 0: setup_s is the clock at the window's start
    assert events[0][2] < events[1][2] < out["metrics"]["setup_s"]["value"]
    assert not os.path.exists(events[0][1])  # removed when the run ended


def test_a_kind_with_prepare_refuses_several_cards():
    cell = _cell()
    cell.chips = 4
    with pytest.raises(NotImplementedError):
        harness.run_cell(cell, SEED, 0.1, False, "cpu", 0.0)


@pytest.mark.parametrize("fault", ["state", "answer", "volume_fraction",
                                   "axes"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from openimpala_tpu_torch import diffusion
    from openimpala_tpu_torch.io.tiff import TiffReader
    from openimpala_tpu_torch.props import tortuosity as pt

    if fault == "state":  # every solve returns its start, converged
        monkeypatch.setattr(pt, "solve_system", _unchanged_state)
    elif fault == "answer":  # tau altered where the CLI gets it
        real = diffusion.tortuosity

        def altered(*a, **k):
            r = real(*a, **k)
            return dataclasses.replace(r, value=r.value * (1 + 1e-5))
        monkeypatch.setattr(diffusion, "tortuosity", altered)
    elif fault == "volume_fraction":  # one cell miscounted
        real_vf = diffusion.volume_fraction_counts

        def miscounted(*a, **k):
            pc, total = real_vf(*a, **k)
            return pc + 1, total
        monkeypatch.setattr(diffusion, "volume_fraction_counts", miscounted)
    else:  # the stack read with X and Y swapped, on the host or a device
        real_thr = TiffReader.threshold
        real_dev = TiffReader.threshold_tensor

        def swapped(self, *a, **k):
            t = real_dev(self, *a, **k)
            return None if t is None else t.transpose(0, 1).contiguous()
        monkeypatch.setattr(TiffReader, "threshold", lambda self, *a, **k:
                            np.ascontiguousarray(
                                real_thr(self, *a, **k).transpose(1, 0, 2)))
        monkeypatch.setattr(TiffReader, "threshold_tensor", swapped)
    out = harness.run_cell(_cell(), SEED, 0.1, False, "cpu", 0.0)
    assert not out["correct"], out["checks"]
