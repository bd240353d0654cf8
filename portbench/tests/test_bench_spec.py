"""BENCHMARK.json against the benchmark's rules, and cells, configurations
and metrics found by their names alone."""

import copy
import json
import os
import shutil

import pytest

from portbench import harness, spec

from conftest import ROOT


def test_benchmark_json_keeps_the_rules():
    assert spec.validate(spec.load()) == []


@pytest.mark.parametrize("where,value,complaint", [
    ("workloads", "tau 512", "name"),
    ("end_to_end", "tokens per second", "unit"),
    ("per_layer", "ms/stepµ", "unit"),
])
def test_validate_refuses_bad_names_and_units(where, value, complaint):
    bench = copy.deepcopy(spec.load())
    if complaint == "name":
        bench[where][0]["name"] = value
    else:
        bench[where][0]["unit"] = value
    assert any(complaint in msg for msg in spec.validate(bench))


@pytest.mark.parametrize("where,key,value,complaint", [
    ("configs", "why", None, "keys"),
    ("workloads", "why", "x" * 201, "why"),
    ("per_layer", "why", "a metric has no why", "keys"),
])
def test_validate_refuses_entries_with_wrong_keys(where, key, value,
                                                  complaint):
    bench = copy.deepcopy(spec.load())
    if value is None:
        del bench[where][0][key]
    else:
        bench[where][0][key] = value
    assert any(complaint in msg for msg in spec.validate(bench))


def test_every_name_and_unit_has_only_allowed_characters():
    bench = spec.load()
    metrics = bench["end_to_end"] + bench["per_layer"]
    for n in ([m["name"] for m in metrics]
              + [c["name"] for c in bench["configs"]]
              + [w["name"] for w in bench["workloads"]]
              + [w["traffic"] for w in bench["workloads"]]):
        assert spec.NAME.match(n), n
    for m in metrics:
        assert spec.UNIT.match(m["unit"]), m


def test_each_per_layer_metric_moves_a_metric_of_its_cells():
    bench = spec.load()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells), (m, w)


def test_a_per_layer_metric_reporting_outside_its_cells_is_refused():
    bench = copy.deepcopy(spec.load())
    m = next(m for m in bench["per_layer"] if m["moves"] == "time_to_tau_s")
    m["workloads"] = m["workloads"] + ["deff512.tensor"]
    assert any("does not report" in msg for msg in spec.validate(bench))


def test_every_cell_has_its_files_and_readers():
    bench = spec.load()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell.traffic["kind"] and cell.config["phase_id"] == 1
        for m in cell.end_to_end:
            assert callable(spec.reader("end_to_end", m["name"]))
        for m in cell.per_layer:
            assert callable(spec.reader("metrics", m["name"]))


def test_a_new_cell_is_found_from_its_files_alone(tmp_path):
    """A cell added as a traffic file and BENCHMARK.json entries, and a
    per-layer metric added as a reader file, run with no code edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load()
    traffic = json.loads((root / "portbench/workloads/tau512.xyz.json")
                         .read_text())
    traffic.update(n=24, volumes=2, porosity=0.5, directions=["Z"])
    traffic["check"]["answers"] = 1
    traffic["trace"]["answers"] = 1
    (root / "portbench/workloads/tau24.z.json").write_text(
        json.dumps(traffic))
    (root / "portbench/metrics/solve.reads_total.tau.py").write_text(
        "def read(traced):\n"
        "    return float(sum(a['graphs']['reads'] for a in traced.answers))\n")
    bench["workloads"].append({
        "name": "tau24.z", "config": "flowthrough-blobs",
        "traffic": "tau24.z", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "time_to_tau_s":
            m["workloads"].append("tau24.z")
    bench["per_layer"].append({
        "name": "solve.reads_total.tau", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "solve",
        "moves": "time_to_tau_s", "workloads": ["tau24.z"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.validate(bench, root=str(root)) == []

    cell = spec.cell(bench, "tau24.z", root=str(root))
    assert [m["name"] for m in cell.per_layer] == ["solve.reads_total.tau"]
    for trace, names in ((False, {"time_to_tau_s", "setup_s"}),
                         (True, {"solve.reads_total.tau"})):
        out = harness.run_cell(cell, 2 ** 31 + 5, 0.2, trace, "cpu", 0.0,
                               root=str(root))
        assert out["correct"], out["checks"]
        assert set(out["metrics"]) == names
    assert harness.forbidden_modules() == []
