"""The controls come out as not correct: at toy sizes on the CPU here, and
at each cell's own size on the card (``-m cuda``, run on the GPU machine
with ``python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests``)."""

from __future__ import annotations

import pytest
import torch

from benchmark import control, harness

CELLS = ("dna512.batch", "rrna16s.align", "rrna16s.score", "dna512.single")


def _files(bench, cell):
    name = cell.split(".")
    config = harness.load(bench, "configs", name[0] + ".json")
    mix = harness.load(bench, "traffic", name[1] + ".json")
    return config, mix


@pytest.mark.parametrize("cell", ["tinydna.batch", "tinydna.single"])
def test_program_control_fails_at_toy_size(toy, cell):
    root, bench = toy
    config, mix = _files(bench, cell)
    spec = harness.load(bench, "controls",
                        cell.replace("tinydna", "dna512") + ".json")
    out = harness.run_cell(cell, 4, 0.2, False, "cpu", root=root,
                           bench_dir=bench,
                           call=control.control_call(config, mix, spec,
                                                     "cpu"))
    assert not out["correct"]


def test_score_bits_control_fails_where_scores_pass_the_register(toy):
    root, bench = toy
    config, mix = _files(bench, "tinyrna.score")
    spec = {"kind": "program", "score_bits": 4}
    out = harness.run_cell("tinyrna.score", 4, 0.2, False, "cpu", root=root,
                           bench_dir=bench,
                           call=control.control_call(config, mix, spec,
                                                     "cpu"))
    assert not out["correct"]


@pytest.mark.parametrize("cell", ["tinyrna.align", "tinydna.batch"])
def test_reference_in_narrow_registers(toy, cell):
    _, bench = toy
    config, mix = _files(bench, cell)
    narrow = control.reference_checks(config, mix, 4, 3, "cpu")
    assert narrow["checks"]["wrong_scores"]["value"] > 0
    wide = control.reference_checks(config, mix, 4, 16, "cpu")
    assert wide["checks"]["wrong_scores"]["value"] == 0
    assert wide["compared"] == narrow["compared"] > 0
    if mix.get("alignment"):
        # The reference gives no alignment: every one counts as wrong.
        assert wide["checks"]["wrong_alignments"]["value"] == \
            wide["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config, mix = _files(harness.HERE, cell)
    spec = harness.load(harness.HERE, "controls", cell + ".json")
    if spec["kind"] == "program":
        out = harness.run_cell(cell, 77, 2, False,
                               call=control.control_call(config, mix, spec,
                                                         "cuda"))
        checks = out["checks"]
    else:
        checks = control.reference_checks(config, mix, 77,
                                          spec["wrap_bits"], "cuda")["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values())
