"""BENCHMARK.json against the rules it is checked by, and the harness finding
a new configuration, traffic mix and metric by name with no edit to any
file that is there."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest(ROOT)


def _metrics(man):
    return man["end_to_end"] + man["per_layer"]


def test_names_and_units(man):
    names = [x["name"] for x in man["configs"] + man["workloads"]
             + _metrics(man)]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for cell in man["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    for m in _metrics(man):
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_cells_resolve_their_files(man):
    configs = {c["name"]: c for c in man["configs"]}
    for cell in man["workloads"]:
        assert cell["chips"] in (1, 4)
        config = configs[cell["config"]]
        assert os.path.isfile(os.path.join(ROOT, config["file"]))
        assert harness.load(BENCH, "configs", cell["config"] + ".json")
        assert harness.load(BENCH, "traffic", cell["traffic"] + ".json")
        assert harness.load(BENCH, "controls", cell["name"] + ".json")
    for c in man["configs"]:
        assert any(w["config"] == c["name"] for w in man["workloads"]), c
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_every_cell_reports_setup_an_end_to_end_and_a_layer(man):
    for cell in man["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(man, cell["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(man, cell["name"], "per_layer")


def test_layer_metrics_move_what_their_cells_report(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [c["name"] for c in man["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_readers_agree_with_the_manifest(man):
    layers = {}
    for m in _metrics(man):
        if m["name"] == "setup_s":
            continue
        mod = harness.reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        if m in man["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
            layers.setdefault(m["layer"], set()).add(m["name"])
    # Metrics of one layer name it letter for letter: no near-duplicates.
    assert len({x.lower() for x in layers}) == len(layers)


def test_new_files_are_found_by_name(toy):
    """A configuration, a mix and a per-layer metric added as new files,
    with new entries in the manifest, run with no other change."""
    root, bench = toy
    with open(os.path.join(bench, "configs", "tinydna.json")) as f:
        config = json.load(f)
    config["name"] = "toyseq"
    config["sequences"]["symbols"] = 2
    with open(os.path.join(bench, "configs", "toyseq.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "pairs.json"), "w") as f:
        json.dump({"entry": "align", "alignment": False, "pool": 3,
                   "lengths": {"kind": "cube", "range": [2, 5]},
                   "shape_seed": 1}, f)
    with open(os.path.join(bench, "metrics", "toy_requests.py"), "w") as f:
        f.write('UNIT = "count"\nSOURCE = "host_clock"\n'
                'LAYER = "entry"\nMOVES = "score_ms"\n\n\n'
                'def read(window):\n    return len(window.records)\n')
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["configs"].append({"name": "toyseq", "source": "a test",
                           "file": "benchmark/configs/toyseq.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "toyseq.pairs", "config": "toyseq",
                             "traffic": "pairs", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "score_ms":
            m["workloads"].append("toyseq.pairs")
    man["per_layer"].append({"name": "toy_requests", "unit": "count",
                             "better": "higher", "source": "host_clock",
                             "layer": "entry", "moves": "score_ms",
                             "workloads": ["toyseq.pairs"]})
    with open(path, "w") as f:
        json.dump(man, f)
    out = harness.run_cell("toyseq.pairs", 3, 0.2, True, "cpu", root=root,
                           bench_dir=bench)
    assert out["correct"]
    assert out["metrics"]["toy_requests"]["value"] == out["attempted"]
    out = harness.run_cell("toyseq.pairs", 3, 0.2, False, "cpu", root=root,
                           bench_dir=bench)
    assert set(out["metrics"]) == {"score_ms", "setup_s"}
