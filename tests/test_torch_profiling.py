"""PyTorch port: ``utils/profiling.py`` against the JAX package's module.

``report``'s table equals the JAX one on the same rows; ``enable``,
``reset`` and ``OPENIMPALA_PROFILE=1`` switch the per-phase table as they
do there; ``phase_timer`` keeps filling the caller's ``timings`` dict; the
port's CLI prints the table under ``OPENIMPALA_PROFILE=1``; and
``device_trace`` writes a Chrome trace on the CPU."""

import contextlib
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


# --- spans on the trace's clock, requests and counters -------------------

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import openimpala_tpu_torch as oit  # noqa: E402
from openimpala_tpu_torch.ops import packfill  # noqa: E402


class _Counting:
    """Counting wrappers around what a scope must not touch when off."""

    NAMES = (("autograd.profiler", "record_function"),
             ("cuda.nvtx", "range_push"), ("cuda.nvtx", "range_pop"),
             ("cuda", "memory_stats"), ("cuda", "synchronize"),
             ("cuda", "is_initialized"))

    def __init__(self, monkeypatch, initialized=False):
        self.calls = {name: 0 for _, name in self.NAMES}
        self.segments = 0
        for mod, name in self.NAMES:
            owner = torch
            for part in mod.split("."):
                owner = getattr(owner, part)
            real = getattr(owner, name)
            fake = {"memory_stats": self._stats,
                    "is_initialized": lambda: initialized,
                    "synchronize": lambda *a, **k: None}.get(name, real)
            monkeypatch.setattr(owner, name, self._counted(name, fake))

    def _counted(self, name, fn):
        def call(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return call

    def _stats(self):
        self.segments += 3  # three cudaMalloc calls between two reads
        return {"segment.all.allocated": self.segments}


def _spans_of(prof_):
    """The ``oi/`` ranges of a CPU trace, ``(start, end, name)``."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof_.profiler.kineto_results.events()
                  if e.name().startswith("oi/"))


def _inside(spans, outer):
    return [s for s in spans if outer[0] <= s[0] and s[1] <= outer[1]
            and s != outer]


def test_an_off_scope_opens_no_range_and_reads_no_allocator(clean,
                                                            monkeypatch):
    seen = _Counting(monkeypatch, initialized=True)
    entry = prof.request("tortuosity")(lambda x: x + 1)
    for _ in range(3):
        with prof.phase_timer(None, "solve", "cuda"):
            pass
        with prof.phase_timer(None, "solve/krylov"):
            pass
        with prof.root("warmup"):
            pass
        assert entry(1) == 2
    assert seen.calls == {name: 0 for name in seen.calls}
    # one shared no-op: an off scope makes no object of its own
    assert prof.phase_timer(None, "a") is prof.phase_timer(None, "b")


def test_a_recorded_request_counts_the_allocator_over_its_root(clean,
                                                               monkeypatch):
    seen = _Counting(monkeypatch, initialized=True)
    entry = prof.request("rev_study")(lambda: None)
    inner = prof.request("effective_diffusivity")(lambda: None)

    def study():
        inner()
        with prof.phase_timer(None, "crop"):
            pass

    before = prof.counters["alloc_segments"]
    with profile(activities=[ProfilerActivity.CPU]):
        prof.request("rev_study")(study)()
        entry()
    assert seen.calls["record_function"] >= 4
    assert seen.calls["synchronize"] == 0  # no timings: no wait
    first, second = list(prof.requests)[-2:]
    assert first["entry"] == second["entry"] == "rev_study"
    assert second["ordinal"] == first["ordinal"] + 1
    assert first["counters"]["alloc_segments"] == 3
    assert prof.counters["alloc_segments"] == before + 6
    assert set(first["spans"]) == {"oi/props/effective_diffusivity",
                                   "oi/props/crop"}
    assert first["spans"]["oi/props/crop"][0] == 1


def test_tortuosity_is_one_root_with_its_scopes_under_it(clean):
    vol = make_blobs(16, 0.5, 0)
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]) as p:
        oit.tortuosity(vol, 1, "X", device="cpu", timings=timings)
    spans = _spans_of(p)
    roots = [s for s in spans if s[2].startswith("oi/request/")]
    assert len(roots) == 1 and roots[0][2].startswith(
        "oi/request/tortuosity#")
    under = {s[2] for s in _inside(spans, roots[0])}
    assert {"oi/props/percolation_mask", "oi/props/label_host",
            "oi/props/mask_upload", "oi/props/system_setup",
            "oi/props/solve", "oi/solve/hierarchy_build",
            "oi/solve/outer_residual", "oi/solve/inner_round",
            "oi/solve/krylov", "oi/props/flux"} <= under
    assert len(under) + 1 == len({s[2] for s in spans})  # nothing outside
    (mask,) = [s for s in spans if s[2] == "oi/props/percolation_mask"]
    assert [s[2] for s in _inside(spans, mask)] == ["oi/props/label_host"]
    record = prof.requests[-1]
    assert record["entry"] == "tortuosity"
    assert set(record["spans"]) == under
    assert record["counters"]["fill_rounds"] == 0  # the host labelled


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "seq"])
def test_rev_study_is_one_root_and_its_crops_are_children(clean, batch):
    vol = make_blobs(24, 0.5, 1)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        oit.rev_study(vol, 1, sizes=(8, 10), num_samples=2, device="cpu",
                      batch=batch)
    spans = _spans_of(p)
    roots = [s for s in spans if s[2].startswith("oi/request/")]
    assert [r[2].split("#")[0] for r in roots] == ["oi/request/rev_study"]
    names = [s[2] for s in _inside(spans, roots[0])]
    assert len(names) + 1 == len(spans)
    assert names.count("oi/props/rev_group") == 2  # one per crop size
    assert "oi/props/draw" in names
    if batch:
        assert names.count("oi/props/crop") == 2
        assert names.count("oi/solve/cell_problem") == 6
        assert {"oi/solve/group_size", "oi/solve/upload",
                "oi/solve/readback", "oi/solve/krylov"} <= set(names)
    else:
        crops = [s for s in spans
                 if s[2] == "oi/props/effective_diffusivity"]
        assert len(crops) == 4
        for c in crops:
            assert "oi/props/host_mask" in [s[2] for s in
                                            _inside(spans, c)]


@pytest.mark.parametrize("entry", ["tortuosity", "effective_diffusivity"])
def test_timings_fill_the_same_keys_under_the_profiler(clean, entry):
    vol = make_blobs(16, 0.5, 0)
    keys = {"mask_upload", "system_setup", "solve", "solve/hierarchy_build",
            "solve/outer_residual", "solve/inner_round"}
    keys |= ({"percolation_mask", "flux"} if entry == "tortuosity"
             else {"hierarchy_build", "deff_tensor"})
    args = (vol, 1, "Y") if entry == "tortuosity" else (vol, 1)
    for traced in (False, True):
        timings = {}
        with profile(activities=[ProfilerActivity.CPU]) if traced \
                else contextlib.nullcontext():
            getattr(oit, entry)(*args, device="cpu", timings=timings)
        assert set(timings) == keys


def test_fill_rounds_count_the_device_fill(clean):
    vol = torch.from_numpy(make_blobs(24, 0.45, 2) == 1)
    for direction in range(3):
        before = prof.counters["fill_rounds"]
        _, _, rounds = packfill.percolation_oneshot_packed(vol, direction)
        assert rounds > 0
        assert prof.counters["fill_rounds"] - before == rounds
    before = prof.counters["fill_rounds"]
    with profile(activities=[ProfilerActivity.CPU]):
        oit.tortuosity(make_blobs(24, 0.45, 2), 1, "Z", device="cpu",
                       percolation_method="device")
    record = prof.requests[-1]
    assert record["counters"]["fill_rounds"] == \
        prof.counters["fill_rounds"] - before > 0
    assert "oi/props/fill_device" in record["spans"]
