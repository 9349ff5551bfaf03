"""The metric arithmetic on synthetic windows and traces, and the traffic
pools' dependence on the seed."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import harness, stats, traffic
from benchmark.trace import Trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def _window(latencies, cells=1000, error_at=(), trace=None,
            kind=H100, counters=None):
    records, t = [], 0.0
    for k, s in enumerate(latencies):
        records.append(harness.Record(
            k % 2, t, t + s, cells, [(0, None)],
            "boom" if k in error_at else None, dict(counters or {}), None))
        t += s
    return harness.Window(records, t, [], trace, kind)


def test_rate_and_per_request_use_the_whole_window():
    w = _window([0.5, 1.0, 1.5, 1.0])
    assert harness.reader("batch_gcups").read(w) == pytest.approx(
        4 * 1000 / 4.0 / 1e9)
    assert harness.reader("align_s").read(w) == pytest.approx(1.0)
    assert harness.reader("score_ms").read(w) == pytest.approx(1000.0)
    # A failed request's time stays in the window; its work does not count.
    w = _window([0.5, 1.0, 1.5, 1.0], error_at=(3,))
    assert harness.reader("batch_gcups").read(w) == pytest.approx(
        3 * 1000 / 4.0 / 1e9)
    assert harness.reader("score_ms").read(w) == pytest.approx(4000 / 3)


def test_p95_is_over_all_requests():
    lat = [0.001 * (k + 1) for k in range(100)]
    assert harness.reader("score_p95_ms").read(_window(lat)) == \
        pytest.approx(95.0)
    # The slow requests are counted wherever they fall, failed ones too.
    lat = [0.001] * 90 + [0.5] * 10
    assert harness.reader("score_p95_ms").read(
        _window(lat[::-1], error_at=range(10))) == pytest.approx(500.0)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_idle_is_one_less_the_union_of_device_intervals():
    tr = Trace([("k", 0.0, 2.0), ("k", 1.0, 3.0), ("Memcpy HtoD", 2.5, 4.0),
                ("k", 6.0, 7.0), ("k", 9.5, 12.0)], [], (0.0, 10.0))
    assert tr.busy_s == pytest.approx(5.5)
    assert tr.window_s == 10.0
    w = _window([1.0], trace=tr)
    for name in ("device_idle_pct.batch", "device_idle_pct.align",
                 "device_idle_pct.single"):
        assert harness.reader(name).read(w) == pytest.approx(45.0)
    assert stats.gaps([(1, 2), (1.5, 3)], (0, 5)) == [(0, 1), (3, 5)]
    assert tr.kernel_s() == pytest.approx(2 + 2 + 1 + 0.5)


def test_idle_gaps_are_labelled_by_the_innermost_host_event():
    tr = Trace([("k", 0.0, 1.0), ("k", 3.0, 4.0)],
               [("bm.request", 0.0, 4.0), ("aten::copy_", 1.5, 2.5),
                ("bm.window", 0.0, 4.0)], (0.0, 4.0))
    assert tr.idle_gaps() == [["aten::copy_", pytest.approx(2.0)]]
    assert tr.top_ops() == [["k", pytest.approx(2.0)]]


@pytest.mark.parametrize("name,kernel,counter", [
    ("k4_roofline", "trialign::hetero_sweep<4>", "k4"),
    ("k3_roofline", "trialign::blocked_persistent<true>", "k3"),
    ("k2_roofline", "trialign::wavefront_sweep<1>", "k2"),
])
def test_roofline_uses_the_frozen_count_and_peak(name, kernel, counter):
    mod = harness.reader(name)
    assert mod.OPS_PER_CELL == 65
    with open(os.path.join(BENCH, "peaks.json")) as f:
        peak = json.load(f)["devices"][H100]["int32_ops_per_s"]
    assert peak == 132 * 1980e6 * 128
    tr = Trace([(kernel, 0.0, 0.25), ("other", 0.25, 0.5)], [], (0.0, 1.0))
    w = _window([0.5, 0.5], cells=10**9, trace=tr, counters={counter: 1})
    want = 100 * 65 * 2 * 10**9 / peak / 0.25
    assert mod.read(w) == pytest.approx(want)
    # Requests another route took, a device the table lacks, or no trace:
    # nothing to read.
    assert mod.read(_window([0.5], trace=tr, counters={counter: 0})) is None
    assert mod.read(_window([0.5], trace=tr, kind="cpu",
                            counters={counter: 1})) is None
    assert mod.read(_window([0.5], counters={counter: 1})) is None


def test_traceback_roofline_counts_every_kernel():
    tr = Trace([("slab_persistent", 0.0, 0.5), ("walk_kernel", 0.5, 0.75),
                ("Memcpy DtoH", 0.75, 0.9)], [], (0.0, 1.0))
    w = _window([1.0], cells=10**9, trace=tr)
    peak = stats.peak(H100, "int32_ops_per_s")
    assert harness.reader("tb_roofline").read(w) == pytest.approx(
        100 * 65e9 / peak / 0.75)


def _config_mix(config, mix):
    return (harness.load(BENCH, "configs", config + ".json"),
            harness.load(BENCH, "traffic", mix + ".json"))


@pytest.mark.parametrize("config,mix", [("dna512", "single"),
                                        ("rrna16s", "score"),
                                        ("rrna16s", "align")])
def test_pools_repeat_for_a_seed_and_differ_across_seeds(config, mix):
    c, m = _config_mix(config, mix)
    big = 2**31 + 12345
    one, again, other = (traffic.pool(c, m, s) for s in (big, big, 7))
    flat = [x for r in one for t in traffic.triplets(r) for x in t]
    assert all((x == y).all() for x, y in zip(
        flat, [x for r in again for t in traffic.triplets(r) for x in t]))
    assert any(len(x) != len(y) or (x != y).any() for x, y in zip(
        flat, [x for r in other for t in traffic.triplets(r) for x in t]))
    # Every seed does the same work: the same shapes, in another order.
    assert sorted(traffic.cells(r) for r in one) == \
        sorted(traffic.cells(r) for r in other)
    assert len(one) == m["pool"]


def test_batch_pool_shapes_and_lengths():
    c, m = _config_mix("dna512", "batch")
    m = dict(m, batch=40)
    one = traffic.pool(c, m, 1)
    other = traffic.pool(c, m, 2)
    assert [len(r) for r in one] == [40] * m["pool"]
    lens = [len(x) for r in one for t in r for x in t]
    assert min(lens) >= 128 and max(lens) <= 512
    assert sorted(traffic.cells(r) for r in one) == \
        sorted(traffic.cells(r) for r in other)


def test_mutated_copies_keep_the_roots_length():
    c, m = _config_mix("rrna16s", "score")
    for a, b, cc in traffic.pool(c, m, 5):
        assert len(a) == len(b) == len(cc)
        assert 1450 <= len(a) <= 1550
        assert (a != b).any() and (b != cc).any() and (a != cc).any()
