"""The readers of the port's host spans: each metric from fixed totals,
None without them (a port without spans, the control, a run with no
launch), and a traced run on the CPU that reads them."""

import sys
import types

import pytest

from portbench import spans, spec
from test_portbench_runs import run

NS = 1_000_000  # 1 ms
TOTALS = {
    "smolscale.scale": {"count": 4, "total_ns": 8 * NS, "self_ns": 2 * NS},
    "smolscale.dispatch": {"count": 4, "total_ns": 1 * NS, "self_ns": 1 * NS},
    "smolscale.tables": {"count": 4, "total_ns": 2 * NS, "self_ns": 2 * NS},
    "smolscale.alloc": {"count": 4, "total_ns": 1 * NS, "self_ns": 1 * NS},
    "smolscale.launch": {"count": 4, "total_ns": 2 * NS, "self_ns": 2 * NS},
    "smolscale.farm.stack": {"count": 1, "total_ns": 50 * NS, "self_ns": 50 * NS},
}
READERS = ["port_ms_per_request", "dispatch_ms_per_request", "launch_ms_per_request"]


def _record(n_requests):
    return types.SimpleNamespace(spans=[(0.0, 0.0, 0.0)] * n_requests)


def _port(monkeypatch, totals):
    mod = types.ModuleType(spans.MODULE)
    if totals is not None:
        mod.span_totals = lambda: {k: dict(v) for k, v in totals.items()}
    monkeypatch.setitem(sys.modules, spans.MODULE, mod)


@pytest.mark.parametrize("name,want", zip(READERS, [2.0, 0.75, 0.75]))
def test_readers_on_fixed_totals(name, want, monkeypatch):
    _port(monkeypatch, TOTALS)
    for metric in (name, name + ".b1"):
        assert spec.metric(metric).read(_record(4)) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_spans(name, monkeypatch):
    reader = spec.metric(name)
    monkeypatch.delitem(sys.modules, spans.MODULE, raising=False)
    assert reader.read(_record(4)) is None  # the control: the port is not loaded
    _port(monkeypatch, None)
    assert reader.read(_record(4)) is None  # a port without spans
    _port(monkeypatch, {})
    assert reader.read(_record(4)) is None  # spans off all along
    _port(monkeypatch, TOTALS)
    assert reader.read(_record(0)) is None  # no request completed


def test_no_launch_reads_none(monkeypatch):
    """The plain versions on the CPU choose a kernel but launch none."""
    _port(monkeypatch, {k: v for k, v in TOTALS.items() if k not in spans.LAUNCH})
    assert spec.metric("launch_ms_per_request").read(_record(4)) is None
    assert spec.metric("dispatch_ms_per_request").read(_record(4)) == pytest.approx(0.75)


def test_a_traced_run_reads_the_spans():
    res = run("sweep-b1", traced=True)
    assert res["correct"]
    port = res["metrics"]["port_ms_per_request.b1"]
    assert port["value"] > 0 and port["unit"] == "ms"
    assert res["metrics"]["dispatch_ms_per_request.b1"]["value"] > 0
    assert "launch_ms_per_request.b1" not in res["metrics"]  # no launch on the CPU
    # the spans were off outside the traced window: a run untraced adds nothing
    before = spans.totals()
    run("sweep-b1")
    assert spans.totals() == before
