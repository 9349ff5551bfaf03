"""The port's CLI against the reference's, on the CPU (``--cpu``).

Each case runs ``trialign_torch.cli.main`` and ``trialign.cli.main`` on the
same arguments and holds the outputs equal: scores exactly, the JSON keys,
the ``i<TAB>score`` lines and the alignment rows.  Also ``metrics`` and the
``selftest`` rows.
"""

import json
import os

import pytest

from trialign import cli as jcli
from trialign.golden import align_planes_numpy
from trialign.io import load_reference_triplet
from trialign_torch import cli, metrics

import trialign.io.datasets as ds

JSON_KEYS = {"score", "backend", "cells", "seconds", "gcups", "device"}


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr()


def port(argv, capsys):
    return run(cli.main, ["--cpu", *argv], capsys)


def reference(argv, capsys):
    return run(jcli.main, argv, capsys)


@pytest.mark.parametrize("backend,ref_backend,port_backend", [
    ("golden", "golden", "golden"), ("xla", "xla", "torch"),
    ("pallas", "pallas_interpret", "wavefront"),
    ("blocked", "blocked", "blocked")])
def test_align_json_matches_reference(capsys, backend, ref_backend,
                                      port_backend):
    argv = ["align", "--a", "ACGTACGTTG", "--b", "ACGACGTA", "--c",
            "ACTTACGGT", "--json", "--backend"]
    got = json.loads(port(argv + [backend], capsys).out)
    want = json.loads(reference(argv + [ref_backend], capsys).out)
    assert set(got) == set(want) == JSON_KEYS
    assert (got["score"], got["cells"]) == (want["score"], want["cells"])
    assert (got["backend"], got["device"]) == (port_backend, "cpu")


def test_align_dat_files_equal_golden(capsys):
    d = ds._DATA_DIR
    argv = ["align", *(x for n in "abc" for x in (
        f"--{n}-file", os.path.join(d, f"{n.upper()}_seq.dat"))), "--json"]
    got = json.loads(port(argv, capsys).out)
    want = json.loads(reference(argv + ["--backend", "golden"], capsys).out)
    assert got["score"] == want["score"] == \
        align_planes_numpy(*load_reference_triplet())
    assert got["backend"] == "wavefront"


def test_align_fasta_triplet(tmp_path, capsys):
    fa = tmp_path / "trip.fa"
    fa.write_text(">A\nACGTACGT\n>B\nACG\nTCGT\n>C\nACGTAGT\n")
    argv = ["align", "--fasta", str(fa), "--backend", "golden", "--json"]
    assert json.loads(port(argv, capsys).out)["score"] == \
        json.loads(reference(argv, capsys).out)["score"]


def test_alignment_output_matches_reference(capsys):
    argv = ["align", "--a", "ACGTACGT", "--b", "ACGACGT", "--c", "ACTTACG",
            "--alignment"]
    got = port(argv, capsys).out.splitlines()
    want = reference(argv, capsys).out.splitlines()
    assert got[0] == want[0] == "score: 12"
    # An optimal alignment is not unique; the port's rows must rescore to
    # the score and hold the inputs.
    rows = [ln.split(": ")[1] for ln in got[2:5]]
    assert [r.replace("-", "") for r in rows] == ["ACGTACGT", "ACGACGT",
                                                  "ACTTACG"]
    assert "ACG-ACGT" in port(argv, capsys).out


def test_batch_matches_reference(tmp_path, capsys):
    f = tmp_path / "trips.tsv"
    f.write_text("ACGT ACGT ACGT\nAAAA TTTT CCCC\n\nACGTTGCA ACGTGCA CGTTGCA\n")
    argv = ["batch", "--tsv", str(f)]
    assert port(argv, capsys).out == reference(argv, capsys).out
    argv.append("--alignment")
    got = port(argv, capsys).out.splitlines()
    want = reference(argv, capsys).out.splitlines()
    assert [ln for ln in got if "\t" in ln] == [ln for ln in want if "\t" in ln]
    assert got[:4] == ["0\t12", "  A: ACGT", "  B: ACGT", "  C: ACGT"]


def test_batch_sharded_names_the_multi_device_slice(tmp_path, capsys):
    """batch --sharded (align_batch_sharded on one CPU slot) prints what
    batch prints; --sharded --alignment is refused, as in the reference."""
    f = tmp_path / "trips.tsv"
    f.write_text("ACGT ACGT ACGT\nAAAA TTTT CCCC\n\nACGTTGCA ACGTGCA "
                 "CGTTGCA\n")
    argv = ["batch", "--tsv", str(f)]
    assert port(argv + ["--sharded"], capsys).out == port(argv, capsys).out
    assert port(argv + ["--sharded"], capsys).out == \
        reference(argv + ["--sharded"], capsys).out
    with pytest.raises(SystemExit, match="without --sharded"):
        cli.main(["--cpu", "batch", "--tsv", str(f), "--sharded",
                  "--alignment"])


def test_metrics_and_profile(tmp_path, capsys):
    prof = str(tmp_path / "trace")
    err = port(["align", "--a", "ACGT", "--b", "ACGT", "--c", "ACGT",
                "--backend", "golden", "--metrics", "--profile", prof],
               capsys).err
    rec = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert rec["score"] == 12 and rec["cells"] == 64
    assert rec["backend"] == "golden" and rec["shape"] == [4, 4, 4]
    assert rec["device"] == "cpu"
    assert os.listdir(prof) == ["trace.json"]
    with open(os.path.join(prof, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert f"profiler trace written to {prof}" in err
    m = metrics.RunMetrics(score=5, cells=1000, backend="x")
    with metrics.timed(m):
        pass
    assert m.to_dict()["score"] == 5 and "gcups" in m.to_dict()


def test_selftest_passes_on_the_cpu(capsys, monkeypatch):
    out = port(["selftest"], capsys).out.splitlines()
    names = [ln.split()[0] for ln in out[:-1]]
    assert names == ["golden", "torch", "wavefront", "blocked", "native-c++",
                     "native-tb", "hirschberg"]
    assert all(ln.endswith("OK") for ln in out[:-1])
    assert out[-1] == "backend: cpu  ->  PASS"
    monkeypatch.setenv("TRIALIGN_FORCE_CPU", "1")
    assert cli.main(["selftest"]) == 0


def test_bench_on_the_cpu_and_its_errors(capsys):
    with pytest.raises(SystemExit, match="wavefront requires"):
        cli.main(["--cpu", "bench", "--mode", "wavefront", "--size", "300"])
    got = json.loads(port(["bench", "--size", "12", "--repeats", "2",
                           "--json"], capsys).out)
    assert (got["mode"], got["parity"], got["backend"]) == \
        ("wavefront", "exact", "cpu")
    assert got["ms_per_alignment"] > 0


def test_without_a_card_the_cli_refuses(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert cli.main(["align", "--a", "A", "--b", "A", "--c", "A"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    # The reference's interpret backend name runs on the CPU.
    assert cli.main(["align", "--a", "AC", "--b", "A", "--c", "C",
                     "--backend", "pallas_interpret"]) == 0
