"""PyTorch port: ``utils/profiling.py`` against the JAX package's module.

``report``'s table equals the JAX one on the same rows; ``enable``,
``reset`` and ``OPENIMPALA_PROFILE=1`` switch the per-phase table as they
do there; ``phase_timer`` keeps filling the caller's ``timings`` dict; the
port's CLI prints the table under ``OPENIMPALA_PROFILE=1``; and
``device_trace`` writes a Chrome trace on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from openimpala_tpu.utils import profiling as jprof  # noqa: E402

from openimpala_tpu_torch import diffusion  # noqa: E402
from openimpala_tpu_torch.utils import profiling as prof  # noqa: E402
from openimpala_tpu_torch.utils.sample_data import make_blobs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def clean(monkeypatch):
    """Both registries empty and off; restored afterwards."""
    monkeypatch.setattr(prof, "_ENABLED", False)
    monkeypatch.setattr(jprof, "_ENABLED", False)
    prof.reset()
    jprof.reset()
    yield
    prof.reset()
    jprof.reset()


ROWS = {"tortuosity/solve": [3, 1.25], "percolation_mask": [1, 0.0625],
        "a_rather_long_phase_name_of_forty_chars!": [7, 12.5],
        "never": [0, 0.0]}


@pytest.mark.parametrize("rows", [{}, ROWS], ids=["empty", "rows"])
def test_report_layout_matches_jax(clean, rows):
    for name, row in rows.items():
        prof._TABLE[name] = list(row)
        jprof._TABLE[name] = list(row)
    assert prof.report() == jprof.report()


def test_report_to_file(clean, capsys):
    prof._TABLE["x"] = [2, 0.5]
    out = prof.report(file=sys.stdout)
    assert capsys.readouterr().out == out + "\n"


def test_enable_and_reset_match_jax(clean):
    for mod, scope in ((prof, lambda n: prof.phase_timer(None, n)),
                       (jprof, jprof.phase_timer)):
        with scope("off"):
            pass
        assert dict(mod._TABLE) == {}
        mod.enable(True)
        for _ in range(2):
            with scope("on"):
                pass
        assert mod._TABLE["on"][0] == 2 and mod._TABLE["on"][1] >= 0.0
        mod.reset()
        assert dict(mod._TABLE) == {}
        mod.enable(False)
    assert not prof._ENABLED


def test_timings_dict_with_profiling_off(clean):
    timings = {}
    for _ in range(3):
        with prof.phase_timer(timings, "step", "cpu"):
            sum(range(1000))
    assert set(timings) == {"step"} and timings["step"] > 0.0
    assert dict(prof._TABLE) == {}


def test_timer_records_when_the_block_raises(clean):
    prof.enable(True)
    timings = {}
    with pytest.raises(ValueError):
        with prof.phase_timer(timings, "boom"):
            raise ValueError("x")
    assert "boom" in timings and prof._TABLE["boom"][0] == 1


@pytest.mark.parametrize("value,on", [("1", True), ("0", False)])
def test_environment_switch_at_import(value, on):
    code = ("import openimpala_tpu_torch.utils.profiling as p; "
            "print(p._ENABLED)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(REPO),
                              "OPENIMPALA_PROFILE": value})
    assert out.stdout.strip() == str(on)


def _cli_inputs(tmp_path, method):
    vol = make_blobs(12, 0.5, 0)
    vol.T.astype(np.uint8).tofile(tmp_path / "v.raw")
    res = tmp_path / "results"
    path = tmp_path / "run.inputs"
    path.write_text(
        f"filename = v.raw\ndata_path = {tmp_path}/\nresults_path = {res}/\n"
        "raw.width = 12\nraw.height = 12\nraw.depth = 12\n"
        "raw.datatype = UINT8\nphase_id = 1\n"
        f"calculation_method = {method}\ndirection = X\nverbose = 1\n")
    return path


@pytest.mark.parametrize("method,phases", [
    ("flow_through", ("percolation_mask", "system_setup", "solve",
                      "solve/inner_round", "cli/read_threshold")),
    ("homogenization", ("system_setup", "hierarchy_build", "solve")),
])
def test_cli_prints_the_table(clean, monkeypatch, tmp_path, capsys, method,
                              phases):
    monkeypatch.setenv("OPENIMPALA_PROFILE", "1")
    assert diffusion.main([str(_cli_inputs(tmp_path, method)),
                           "device=cpu"]) == 0
    out = capsys.readouterr().out
    head = "Per-phase wall-clock (OPENIMPALA_PROFILE=1):"
    assert head in out
    table = out.split(head, 1)[1].strip().splitlines()
    assert table[0] == jprof.report().splitlines()[0]  # the JAX header
    names = {line.split()[0] for line in table[1:]
             if line and not line.startswith("Total")}
    assert set(phases) <= names


def test_cli_without_the_switch_prints_no_table(clean, monkeypatch,
                                                tmp_path, capsys):
    monkeypatch.delenv("OPENIMPALA_PROFILE", raising=False)
    assert diffusion.main([str(_cli_inputs(tmp_path, "flow_through")),
                           "device=cpu"]) == 0
    assert "Per-phase wall-clock" not in capsys.readouterr().out


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with prof.device_trace(str(logdir)):
        x = torch.ones((64, 64))
        (x @ x).sum()
    files = sorted(logdir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with prof.device_trace(str(logdir)):
        torch.zeros(3).add_(1)
    assert len(sorted(logdir.glob("trace_*.json"))) == 2
