"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by its name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``workloads/<traffic>.json`` (``traffic.py`` reads it);
* an end-to-end metric: ``end_to_end/<name>.py``, a ``read(window)``;
* a per-layer metric: ``metrics/<name>.py``, a ``read(traced)``.

A reader returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")
# The keys each entry has; a metric may add ``workloads``.
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports
    per_layer: list


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "workloads",
                           f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(name, int(entry["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def reader(group: str, name: str, root: str = ROOT):
    """The ``read`` function of ``portbench/<group>/<name>.py``."""
    path = os.path.join(root, "portbench", group, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{group}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def validate(bench: dict, root: str = ROOT) -> list:
    """What in ``bench`` breaks the benchmark's rules: a list of
    messages, empty when none does."""
    bad = []
    if set(bench) != set(TOP_KEYS):
        bad.append(f"top-level keys {sorted(bench)}")
    for group, keys in ENTRY_KEYS.items():
        for entry in bench.get(group, []):
            extra = {"workloads"} if group in ("end_to_end", "per_layer") \
                else set()
            if not keys <= set(entry) <= keys | extra:
                bad.append(f"{group} entry {entry.get('name')!r}: keys "
                           f"{sorted(entry)}")
            for k in ("why", "layer", "source"):
                text = entry.get(k, "x")
                if not (isinstance(text, str) and 1 <= len(text) <= 200
                        and "\n" not in text and "\t" not in text):
                    bad.append(f"{group} entry {entry.get('name')!r}: {k}")
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    configs = {c["name"]: c for c in bench.get("configs", [])}
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    names = (list(cells) + list(configs) + list(e2e)
             + [m["name"] for m in bench.get("per_layer", [])])
    for n in names + [w["traffic"] for w in cells.values()] + [
            k for c in configs.values() for k in c["reduced"]]:
        if not NAME.match(n):
            bad.append(f"name {n!r}")
    metrics = list(e2e.values()) + bench.get("per_layer", [])
    if len({m["name"] for m in metrics}) != len(metrics):
        bad.append("two metrics share a name")
    for m in metrics:
        if not UNIT.match(m["unit"]):
            bad.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            bad.append(f"better of {m['name']}")
        if m["source"] not in SOURCES:
            bad.append(f"source of {m['name']}")
        for w in m.get("workloads", []):
            if w not in cells:
                bad.append(f"{m['name']} names no cell {w!r}")
    for m in e2e.values():
        if m["source"] not in ("host_clock", "device_trace"):
            bad.append(f"end-to-end {m['name']} from {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            bad.append(f"bound of {m['name']}")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in bench.get("per_layer", []):
        moves = e2e.get(m["moves"])
        if moves is None:
            bad.append(f"{m['name']} moves no end-to-end metric")
            continue
        for w in m.get("workloads", list(cells)):
            if not _reports(moves, w):
                bad.append(f"{m['name']} in {w}, which does not report "
                           f"{m['moves']}")
    for c in configs.values():
        if not os.path.exists(os.path.join(root, c["file"])):
            bad.append(f"no file {c['file']}")
    for w in cells.values():
        if w["config"] not in configs:
            bad.append(f"{w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4):
            bad.append(f"{w['name']}: chips {w['chips']}")
        if not os.path.exists(os.path.join(
                root, "portbench", "workloads", f"{w['traffic']}.json")):
            bad.append(f"{w['name']}: no traffic file")
        mine = [m for m in metrics if _reports(m, w["name"])]
        if not any(m["name"] == "setup_s" for m in mine) or len(
                [m for m in mine if m["name"] in e2e]) < 2:
            bad.append(f"{w['name']}: too few end-to-end metrics")
        if not [m for m in mine if m["name"] not in e2e]:
            bad.append(f"{w['name']}: no per-layer metric")
    for group, entries in (("end_to_end", e2e.values()),
                           ("metrics", bench.get("per_layer", []))):
        for m in entries:
            if not os.path.exists(os.path.join(root, "portbench", group,
                                               f"{m['name']}.py")):
                bad.append(f"no reader portbench/{group}/{m['name']}.py")
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    if len(set(pairs)) != len(pairs):
        bad.append("a (config, traffic) pair appears twice")
    return bad
