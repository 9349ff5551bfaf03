"""The readers of the program's own spans and cell counters
(``benchmark/layers.py``) on synthetic windows: known values from hand-made
host spans and counters, and nothing to read without a trace, without
spans or without the counters (a program from before them)."""

from __future__ import annotations

import pytest

from benchmark import harness, layers, stats
from benchmark.trace import Trace
from trialign_torch.kernels import slab

H100 = "NVIDIA H100 80GB HBM3"
SLAB_COUNTERS = ("slab_sweep", "sweep_tiles", "choice_sweep")


def _window(n_done, trace, cells=10**9, kind=H100, failed=0):
    records = [harness.Record(k % 2, float(k), k + 1.0, cells, [(0, None)],
                              "boom" if k < failed else None, {}, None)
               for k in range(n_done + failed)]
    return harness.Window(records, float(len(records)), [], trace, kind)


@pytest.mark.parametrize("name,root", [
    ("host_ms.batch", "trialign.align_batch"),
    ("host_ms.align", "trialign.align"),
    ("host_ms.single", "trialign.align"),
])
def test_host_ms_is_the_roots_less_their_waits(name, root):
    mod = harness.reader(name)
    host = [
        ("bm.request", 0.0, 1.0), (root, 0.1, 0.9),
        ("trialign.route", 0.1, 0.2), ("trialign.wait", 0.4, 0.8),
        ("bm.request", 1.0, 2.0), (root, 1.0, 1.5),
        ("trialign.k2.pack", 1.1, 1.2), ("trialign.wait", 1.2, 1.3),
        ("trialign.wait", 1.25, 1.45),
        # A root inside a root counts once; a wait outside any is not the
        # program's host time.
        (root, 1.05, 1.1), ("trialign.wait", 2.5, 2.9),
    ]
    tr = Trace([], host, (0.0, 3.0))
    # (0.8 - 0.4) + (0.5 - 0.25), over two completed requests.
    assert mod.read(_window(2, tr)) == pytest.approx(1e3 * 0.65 / 2)
    # A failed request's spans count; only completed ones divide.
    assert mod.read(_window(1, tr, failed=1)) == pytest.approx(1e3 * 0.65)
    other = "trialign.align" if root != "trialign.align" \
        else "trialign.align_batch"
    assert mod.read(_window(2, Trace([], [(other, 0.0, 1.0)],
                                     (0.0, 1.0)))) is None
    assert mod.read(_window(2, None)) is None
    assert mod.read(_window(0, tr)) is None


def test_waits_inside_roots_are_intersected_in_order():
    outer = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)]
    inner = [(-1.0, 0.5), (0.9, 2.5), (2.6, 2.7), (4.0, 7.0)]
    assert layers._inside(outer, inner) == pytest.approx(
        0.5 + 0.1 + 0.5 + 0.1 + 1.0)
    assert layers._inside([], inner) == 0.0
    assert layers._inside(outer, []) == 0.0


@pytest.fixture
def bump(monkeypatch):
    """The slab counters at values of the test's own, and a function that
    advances them as launches would."""
    for name, start in zip(SLAB_COUNTERS, (7, 11, 13)):
        monkeypatch.setattr(getattr(slab, name), "cells", start)

    def advance(**cells):
        for name, n in cells.items():
            getattr(slab, name).cells += n

    return advance


@pytest.mark.parametrize("name,ops,kernel,moved", [
    ("k5_roofline", 65, "trialign::slab_persistent",
     {"slab_sweep": 3 * 10**9, "sweep_tiles": 10**9}),
    ("choices_roofline", 88, "trialign::choices_persistent",
     {"choice_sweep": 4 * 10**9}),
])
def test_counter_rooflines(bump, name, ops, kernel, moved):
    mod = harness.reader(name)
    assert mod.OPS_PER_CELL == ops
    tr = Trace([(kernel, 0.0, 0.5), ("trialign::walk_kernel", 0.5, 0.6),
                ("Memcpy DtoH", 0.6, 0.7)], [], (0.0, 1.0))
    mod.install(harness.Probe())
    # Cells swept by another kernel's counter move nothing here.
    other = {"choice_sweep": 10**12} if name == "k5_roofline" \
        else {"slab_sweep": 10**12}
    bump(**moved, **other)
    peak = stats.peak(H100, "int32_ops_per_s")
    assert mod.read(_window(3, tr)) == pytest.approx(
        100 * ops * 4e9 / peak / 0.5)
    assert mod.read(_window(3, None)) is None
    assert mod.read(_window(3, tr, kind="cpu")) is None
    # Nothing swept, or the kernel absent from the trace: nothing to read.
    mod.install(harness.Probe())
    assert mod.read(_window(3, tr)) is None
    bump(**moved)
    assert mod.read(_window(3, Trace([], [], (0.0, 1.0)))) is None


def test_swept_ratio_counts_every_traceback_sweep(bump):
    mod = harness.reader("tb_swept_ratio")
    mod.install(harness.Probe())
    bump(slab_sweep=3 * 10**9, sweep_tiles=10**9, choice_sweep=5 * 10**8)
    # 4.5e9 cells swept for two completed alignments of 1e9 cells; the
    # failed one's cells do not count.
    assert mod.read(_window(2, None, failed=1)) == pytest.approx(2.25)
    assert mod.read(_window(0, None)) is None


@pytest.mark.parametrize("name", ["k5_roofline", "choices_roofline",
                                  "tb_swept_ratio"])
def test_counter_readers_read_nothing_without_the_counters(monkeypatch,
                                                           name):
    """A program whose slab kernel has no ``.cells`` (or no slab kernel):
    the readers return None and raise nothing."""
    for counter in SLAB_COUNTERS:
        monkeypatch.delattr(getattr(slab, counter), "cells")
    mod = harness.reader(name)
    mod.install(harness.Probe())
    tr = Trace([("trialign::slab_persistent", 0.0, 0.5),
                ("trialign::choices_persistent", 0.5, 0.7)], [], (0.0, 1.0))
    assert mod.read(_window(2, tr)) is None
    monkeypatch.setattr(layers, "SLAB", "trialign_torch.no_such_module")
    mod.install(harness.Probe())
    assert mod.read(_window(2, tr)) is None
