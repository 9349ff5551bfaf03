"""Shared fixtures of the benchmark's CPU tests: a toy copy of the benchmark
(its manifest, configurations and mixes cut to sizes the plain versions of
the kernels sweep in seconds) that ``harness.run_cell`` runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
TOY = {"dna512": "tinydna", "rrna16s": "tinyrna"}


def toy_name(cell: str) -> str:
    config, mix = cell.split(".", 1)
    return TOY[config] + "." + mix


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """(root, bench_dir) of a toy benchmark: the real cells, metrics and
    readers, on triplets of a few symbols.  K4's route is open on the CPU
    (TRIALIGN_FORCE_MOSAIC=1), as it is on the card."""
    monkeypatch.setenv("TRIALIGN_FORCE_MOSAIC", "1")
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(BENCH, "metrics"), bench / "metrics")
    shutil.copytree(os.path.join(BENCH, "controls"), bench / "controls")
    for d in ("configs", "traffic"):
        (bench / d).mkdir()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for cell in man["workloads"]:
        cell["config"] = TOY[cell["config"]]
        cell["name"] = toy_name(cell["name"])
    for section in ("end_to_end", "per_layer"):
        for m in man[section]:
            if "workloads" in m:
                m["workloads"] = [toy_name(w) for w in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    for real, small in TOY.items():
        with open(os.path.join(BENCH, "configs", real + ".json")) as f:
            config = json.load(f)
        config["name"] = small
        if config["sequences"]["kind"] == "mutated_root":
            config["sequences"]["root_length"] = [14, 20]
        (bench / "configs" / (small + ".json")).write_text(json.dumps(config))
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as f:
            mix = json.load(f)
        if mix.get("batch"):
            mix["batch"], mix["check_sample"] = 64, 40
        if mix.get("lengths"):
            mix["lengths"]["range"] = [3, 8]
        mix["pool"] = min(mix["pool"], 4)
        (bench / "traffic" / name).write_text(json.dumps(mix))
    return str(tmp_path), str(bench)
