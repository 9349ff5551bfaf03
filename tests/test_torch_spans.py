"""The port's spans (``metrics.span``) and the slab kernel's cell counters.

While no profiler records, a span is a shared no-op context and enters no
``record_function``.  Under ``torch.profiler`` each public call records
``trialign.*`` spans, nested by layer: the entry (``align``,
``align_batch``) around routing, packing, waiting and the traceback's
nodes.  On the CPU the kernels run their plain versions, so no
``.launch`` span shows; the cases marked ``cuda`` hold the launches, the
device timeline and the ``.cells`` counters on the card.  The file imports
neither JAX nor the JAX package, so the ``cuda`` cases run on a GPU
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_spans.py
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trialign_torch import api, metrics
from trialign_torch.kernels import hetero
from trialign_torch.kernels import slab as sk
from trialign_torch.traceback import direct
from trialign_torch.traceback import hirschberg as H

PREFIX = "trialign."


def triplet(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 4, n).astype(np.uint8) for n in shape)


def spans(fn, cuda=False):
    """(fn's result, [(span, its parent span or None)] of the package's
    spans on the host in the order they opened, the names of the device's
    operations other than the spans' own ranges)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    # The raw events: FunctionEvents of every plain operator take minutes
    # to build on the CPU.
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    host = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in events
                  if e.device_type() == cpu and e.name().startswith(PREFIX))
    device = [e.name() for e in events
              if e.device_type() != cpu and not e.is_user_annotation()]
    pairs, stack = [], []
    for start, neg_end, name in host:
        while stack and stack[-1][1] <= start:
            stack.pop()
        pairs.append((name, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return out, pairs, device


def names(pairs):
    return {n[len(PREFIX):] for n, _ in pairs}


def test_span_enters_no_range_while_no_profiler_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert metrics.span("align") is metrics.span("wait")
    with metrics.span("align"):
        pass
    a, b, c = triplet(0, (6, 5, 7))
    assert api.align(a, b, c, device="cpu").score == \
        api.align(a, b, c, backend="golden", device="cpu").score


@pytest.mark.parametrize("shape,backend,pack", [
    ((6, 5, 7), "wavefront", "k2.pack"),
    ((4, 260, 3), "blocked", "k3.pack"),
], ids=["k2", "k3"])
def test_align_records_its_layers(shape, backend, pack):
    a, b, c = triplet(1, shape)
    res, pairs, _ = spans(lambda: api.align(a, b, c, device="cpu"))
    assert res.backend == backend
    assert pairs[0] == ("trialign.align", None)
    assert set(pairs) == {("trialign.align", None),
                          ("trialign.route", "trialign.align"),
                          ("trialign." + pack, "trialign.align"),
                          ("trialign.wait", "trialign.align")}
    # The route comes first, the wait for the score last.
    assert pairs[1][0] == "trialign.route"
    assert pairs[-1][0] == "trialign.wait"


def test_align_batch_records_the_mosaic_route(monkeypatch):
    monkeypatch.setenv("TRIALIGN_FORCE_MOSAIC", "1")
    # Small tiles: the plain version sweeps a tile's every plane.
    monkeypatch.setattr(hetero.bk, "choose_block_shape",
                        lambda la, lb, lc: (5, 5))
    rng = np.random.default_rng(2)
    trips = [tuple(rng.integers(0, 4, n).astype(np.uint8)
                   for n in rng.integers(2, 6, 3)) for _ in range(64)]
    assert api.batch_routes([[len(x) for x in t] for t in trips],
                            api.Scoring(), True) == ["mosaic"] * 64
    res, pairs, _ = spans(lambda: api.align_batch(trips, device="cpu"))
    assert [r.score for r in res] == [
        api.align(*t, backend="golden", device="cpu").score for t in trips]
    assert pairs[0] == ("trialign.align_batch", None)
    root = "trialign.align_batch"
    assert set(pairs) == {(root, None), ("trialign.route", root),
                          ("trialign.k4.plan", root),
                          ("trialign.k4.pack", root),
                          ("trialign.wait", root)}
    assert pairs[-1][0] == "trialign.wait"


def test_alignment_records_each_hirschberg_node(monkeypatch):
    """Splits on K5's plain version, direct leaves and base-case walks:
    every node's span nests in the split that made it, the sweeps' staging
    and the waits for their results in the node that ran them; K5's
    staging copies wait for the sweeps queued before them."""
    for name, value in {"BASE_CELLS": 1 << 9, "DIRECT_CELLS": 1 << 10,
                        "_DIRECT_SAFE_CELLS": 1 << 10}.items():
        monkeypatch.setattr(H, name, value)
    monkeypatch.setattr(sk.bk, "choose_block_shape",
                        lambda la, lb, lc: (9, 17))
    monkeypatch.setenv("TRIALIGN_SLAB_FORCE", "1")
    a, b, c = triplet(3, (18, 26, 40))
    res, pairs, _ = spans(lambda: api.align(a, b, c, return_alignment=True,
                                            device="cpu"))
    assert res.score == api.align(a, b, c, backend="golden",
                                  device="cpu").score
    assert pairs[:3] == [("trialign.align", None),
                         ("trialign.route", "trialign.align"),
                         ("trialign.tb.split", "trialign.align")]
    assert {"tb.split", "tb.direct", "tb.walk", "k5.pack",
            "wait"} <= names(pairs)
    nodes = ("trialign.tb.split", "trialign.tb.restart")
    for name, parent in pairs[3:]:
        if name.startswith("trialign.tb."):
            assert parent in nodes, (name, parent)
        elif name == "trialign.k5.pack":
            assert parent == "trialign.tb.split"
        else:
            assert name == "trialign.wait", name
            assert parent in ("trialign.k5.pack", "trialign.tb.split",
                              "trialign.tb.direct"), parent


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 300], ids=["k2", "k3"])
def test_traced_call_on_the_card(card, n):
    """A call of ``dna512.single``'s size: every span on the host timeline,
    the launch among them, and none among the device's operations."""
    a, b, c = triplet(4, (n, n, n))
    api.align(a, b, c)  # builds the kernel
    res, pairs, device = spans(lambda: api.align(a, b, c), cuda=True)
    k = "k2" if res.backend == "wavefront" else "k3"
    assert (res.backend, k) in (("wavefront", "k2"), ("blocked", "k3"))
    assert names(pairs) == {"align", "route", k + ".pack", k + ".launch",
                            "wait"}
    assert all(p == "trialign.align" for _, p in pairs[1:])
    assert any(k in n for n in device for k in ("wavefront_sweep",
                                                "blocked_persistent"))
    assert not [n for n in device if n.startswith(PREFIX)]


def _cells():
    return {f: getattr(sk, f).cells for f in ("slab_sweep", "sweep_tiles",
                                              "choice_sweep")}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 2048])
def test_slab_counters_count_the_cells_swept(card, monkeypatch, n):
    """A 512^3 alignment is one direct node: its choice sweep counts n^3.
    A 2048^3 one splits on K5 (the forward sweep of A[:m], the backward one
    of A[m:] and, in a free mode, the guard over A[m:]) over direct leaves,
    which count their own cuboids."""
    splits, leaves = [], []
    real_split, real_direct = H._split, direct.direct_traceback

    def split(a, b, c, scoring, mode, *args):
        m, rest = len(a) // 2, len(a) - len(a) // 2
        sweeps = m + rest + (rest if mode != "pin" else 0)
        splits.append(sweeps * len(b) * len(c))
        return real_split(a, b, c, scoring, mode, *args)

    def leaf(a, b, c, *args, **kwargs):
        leaves.append(len(a) * len(b) * len(c))
        return real_direct(a, b, c, *args, **kwargs)

    monkeypatch.setattr(H, "_split", split)
    monkeypatch.setattr(direct, "direct_traceback", leaf)
    a, b, c = triplet(5, (n, n, n))
    before = _cells()
    api.align(a, b, c, return_alignment=True)
    moved = {k: v - before[k] for k, v in _cells().items()}
    assert len(splits) == (0 if n == 512 else 1)
    assert len(leaves) == (1 if n == 512 else 2)
    assert moved == {"slab_sweep": sum(splits), "sweep_tiles": 0,
                     "choice_sweep": sum(leaves)}
    if n == 2048:
        assert sum(splits) == 3 * (n // 2) * n * n
