"""The port's host spans (``smolscale_tpu_torch.utils.timing.span``) on the
CPU: off without a profiler, one outermost span a public call under one,
self times that add up, and names apart from the benchmark's own spans."""

import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import smolscale_tpu_torch as stt
from smolscale_tpu_torch.utils import timing

OUTERMOST = ("smolscale.scale", "smolscale.scale_rows", "smolscale.pyramid")
PLAN = (64, 48, 20, 15, 0, 0)


def _image():
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, 256, (48, 64, 4), dtype=np.uint8))


def _added(before: dict, after: dict) -> dict:
    """The totals that ``after`` adds to ``before``, by name."""
    zero = {"count": 0, "total_ns": 0, "self_ns": 0}
    out = {}
    for name, t in after.items():
        b = before.get(name, zero)
        if t["count"] != b["count"]:
            out[name] = {k: t[k] - b[k] for k in zero}
    return out


def _traced(fn):
    """Run ``fn`` under a host profiler: the spans' added totals and the
    profiler's events."""
    before = timing.span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _added(before, timing.span_totals()), list(prof.profiler.kineto_results.events())


def test_spans_are_off_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler")

    monkeypatch.setattr(timing, "_record", refuse)
    before = timing.span_totals()
    plan, x = stt.ScalePlan(*PLAN), _image()
    stt.scale(plan, x)
    stt.scale_rows(plan, x, 2, 5)
    stt.make_pyramid_fn(64, 64, 0, sizes=(8, 16), device="cpu")(torch.zeros((1, 64, 64, 4),
                                                                             dtype=torch.uint8))
    with timing.span("smolscale.scale"):
        assert not timing._profiler._is_profiler_enabled and timing._stacks == {}
    assert timing.span_totals() == before


def test_spans_off_leave_new_threads_untouched(monkeypatch):
    """With no profiler, threads that call the port touch no span state:
    neither the thread-local stacks nor the totals."""
    def refuse(name):
        raise AssertionError(f"span {name} recorded with no profiler")

    def untouched():
        raise AssertionError("per-thread span state looked up with no profiler")

    monkeypatch.setattr(timing, "_record", refuse)
    monkeypatch.setattr(timing, "get_ident", untouched)
    before, registered = timing.span_totals(), len(timing._totals)
    plan, x = stt.ScalePlan(*PLAN), _image()
    failed = []

    def work():
        try:
            stt.scale(plan, x)
            stt.scale_rows(plan, x, 2, 5)
        except Exception as e:  # noqa: BLE001 -- reported below
            failed.append(e)

    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert failed == []
    assert timing._stacks == {} and len(timing._totals) == registered
    assert timing.span_totals() == before


def _calls():
    plan, x = stt.ScalePlan(*PLAN), _image()
    fused = stt.make_pyramid_fn(64, 64, 0, sizes=(8, 16, 32), device="cpu")
    levels = stt.make_pyramid_fn(64, 64, 0, sizes=(16, 24), device="cpu")
    batch = torch.zeros((2, 64, 64, 4), dtype=torch.uint8)
    return {
        # name: (call, outermost spans it opens, whether a kernel is chosen)
        "scale": (lambda: stt.scale(plan, x), {"smolscale.scale": 1}, True),
        "scale_simple": (lambda: stt.scale_simple(x, 0, 20, 15), {"smolscale.scale": 1}, True),
        "scale_rows": (lambda: stt.scale_rows(plan, x, 3, 4), {"smolscale.scale_rows": 1}, True),
        "scale_streamed": (lambda: list(stt.scale_streamed(plan, x, n_chunks=3)),
                           {"smolscale.scale_rows": 3}, True),
        "pyramid": (lambda: fused(batch), {"smolscale.pyramid": 1}, False),
        "pyramid_by_level": (lambda: levels(batch), {"smolscale.pyramid": 1}, True),
    }


@pytest.mark.parametrize("entry", list(_calls()))
def test_one_outermost_span_a_call(entry):
    call, outer, dispatched = _calls()[entry]
    call()
    added, events = _traced(call)
    assert {n: t["count"] for n, t in added.items() if n in OUTERMOST} == outer
    # at most 5 spans a scale call; the self times add up to the outermost totals
    if entry != "pyramid_by_level":
        assert sum(t["count"] for t in added.values()) <= 5 * sum(outer.values())
    assert sum(t["self_ns"] for t in added.values()) == \
        sum(added[n]["total_ns"] for n in outer)
    assert all(0 <= t["self_ns"] <= t["total_ns"] for t in added.values())
    host = {e.name() for e in events if "CUDA" not in str(e.device_type())}
    assert set(outer) <= host
    assert ("smolscale.dispatch" in host) == dispatched
    assert ("smolscale.dispatch" in added) == dispatched


def test_span_names_stay_apart_from_the_benchmarks():
    """Every span the port opens is ``smolscale.<layer>``, never one of the
    benchmark's own span names, and is a host op in the profiler's trace
    (no user annotation, which the profiler mirrors on the device)."""
    pkg = Path(stt.__file__).parent
    names = {n for f in pkg.rglob("*.py")
             for n in re.findall(r"span\(\"([^\"]+)\"\)", f.read_text())}
    assert set(OUTERMOST) | {"smolscale.dispatch", "smolscale.tables", "smolscale.alloc",
                             "smolscale.launch", "smolscale.farm.group", "smolscale.farm.stack",
                             "smolscale.farm.upload", "smolscale.farm.download"} == names
    assert all(n.startswith("smolscale.") for n in names)
    assert not names & {"window", "request", "ready"}
    _, events = _traced(lambda: stt.scale(stt.ScalePlan(*PLAN), _image()))
    kinds = {e.activity_type() for e in events if e.name().startswith("smolscale.")
             if hasattr(e, "activity_type")}
    assert kinds <= {"cpu_op"}


def test_nested_spans_and_threads():
    """Self time is the total less the child spans of the same thread; a
    span ended early leaves its block's later spans to its parent; a span
    whose block raises is closed; one span object may be entered inside
    itself."""
    def work():
        with timing.span("t.outer"):
            tables = timing.span("t.tables")
            with tables:
                torch.empty(8)
                tables.end()
                with timing.span("t.launch"):
                    torch.empty(8)
            other = threading.Thread(target=lambda: timing.span("t.other").__enter__().end())
            other.start()
            other.join()
        with pytest.raises(ValueError), timing.span("t.raises"):
            raise ValueError
        again = timing.span("t.again")
        with again, again:
            torch.empty(8)

    added, _ = _traced(work)
    assert {n: t["count"] for n, t in added.items()} == {
        "t.outer": 1, "t.tables": 1, "t.launch": 1, "t.other": 1, "t.raises": 1, "t.again": 2}
    outer = added["t.outer"]
    assert outer["self_ns"] == outer["total_ns"] - added["t.tables"]["total_ns"] - \
        added["t.launch"]["total_ns"]
    assert added["t.again"]["self_ns"] < added["t.again"]["total_ns"]  # inner from outer
    assert timing._stacks == {}


def test_farm_spans():
    images = [np.zeros((64, 64, 4), np.uint8)] * 3 + [np.zeros((32, 32, 4), np.uint8)]
    added, _ = _traced(lambda: stt.scale_pyramid_mixed(images, [0, 0, 0, 0], sizes=(8, 16),
                                                       max_batch_bytes=2 * 64 * 64 * 4,
                                                       device="cpu"))
    # grouping once, one stack a sub-batch (3 of them), one pyramid call each
    assert added["smolscale.farm.group"]["count"] == 1
    assert added["smolscale.farm.stack"]["count"] == 3
    assert added["smolscale.farm.download"]["count"] == 1
    assert added["smolscale.pyramid"]["count"] == 3
    assert "smolscale.farm.upload" not in added  # no pinned ring on the CPU


def test_threads_keep_their_own_stacks():
    """Many threads entering the same span objects, switching often: every
    span is counted once, and each thread's self times add up to its
    outermost spans' total."""
    outer, inner = timing.span("t.stress.outer"), timing.span("t.stress.inner")
    n_threads, n_calls = 8, 300

    def work():
        for _ in range(n_calls):
            with outer:
                with inner:
                    pass
                inner.__enter__()
                inner.end()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)

        added, _ = _traced(run)
    finally:
        sys.setswitchinterval(interval)
    assert added["t.stress.outer"]["count"] == n_threads * n_calls
    assert added["t.stress.inner"]["count"] == 2 * n_threads * n_calls
    assert added["t.stress.outer"]["self_ns"] + added["t.stress.inner"]["self_ns"] == \
        added["t.stress.outer"]["total_ns"]
