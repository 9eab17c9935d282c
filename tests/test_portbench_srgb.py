"""The benchmark's linear-light sweep (``frames-2160p-srgb``,
``sweep2160-srgb-b32``) on the CPU: the configuration's 200 plans, the
cell's entry in ``BENCHMARK.json``, the routing of the plans to the kernels
at the published 3840x2160 widths and in which working mode, the port
against ``portbench/reference`` on every step at a small source, and whole harness runs of the cell's entry at that size, the
control among them.  No assert here counts the requests of a timed window."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

import smolscale_tpu_torch as stt
from portbench import control, counters, harness, spec, traffic
from portbench.reference import scale as reference
from portbench.reference.plan import ScalePlan as RefPlan
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import bilinear, bilinear128, box, deep
from smolscale_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
CELL = "sweep2160-srgb-b32"
CONFIG = json.loads((ROOT / "portbench" / "configs" / "frames-2160p-srgb.json").read_text())
GAMMA = json.loads((ROOT / "portbench" / "configs" / "frames-2160p.json").read_text())
WORKLOAD = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
PLANS = traffic.frame_plans(CONFIG["frames"])
# the cell's frames at 96x54: the same 200 steps, 1x1 to 192x108
SMALL = {"frames": {**CONFIG["frames"], "width": 96, "height": 54}}
SMALL_PLANS = traffic.frame_plans(SMALL["frames"])
SMALL_CELL = {**WORKLOAD, "batch": 2, "resident_frames": 4}


def test_the_configuration_is_the_sweep_in_linear_light():
    """frames-2160p's 200 plans, sizes and pixel pair, with sRGB on."""
    assert len(PLANS) == 200
    assert [a[:6] for a in PLANS] == [a[:6] for a in traffic.frame_plans(GAMMA["frames"])]
    assert all(a[6] is True for a in PLANS)
    assert PLANS[0][2:4] == (76, 43) and PLANS[-1][2:4] == (7680, 4320)
    assert {k: v for k, v in CONFIG["frames"].items() if k != "with_srgb"} == {
        k: v for k, v in GAMMA["frames"].items() if k != "with_srgb"}
    assert CONFIG["frames"]["with_srgb"] is True and CONFIG["reduced"] == []
    assert all(stt.ScalePlan(*a).storage == stt.StorageType.S128 for a in PLANS)


def test_the_cell_is_in_the_benchmark():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    assert cell["config"] == "frames-2160p-srgb" and cell["chips"] == 1
    assert cell["traffic"] == CELL
    assert spec.config(bench, "frames-2160p-srgb") == CONFIG
    assert spec.workload(CELL) == WORKLOAD
    assert WORKLOAD["entry"] == "scale" and WORKLOAD["check_requests"] == 2
    assert (WORKLOAD["batch"], WORKLOAD["resident_frames"]) == (32, 32)
    assert set(spec.cell_metrics(bench, CELL, False)) == {
        "mpix_per_s", "request_p95_ms", "setup_s"}
    assert {"device_idle_pct", "kernel_roofline_pct", "launches_per_request",
            "port_ms_per_request", "dispatch_ms_per_request", "launch_ms_per_request",
            "bilinear128_roofline_pct", "deep_roofline_pct"} <= set(
                spec.cell_metrics(bench, CELL, True))
    assert spec.metric("deep_roofline_pct").MOVES == "mpix_per_s"


def test_the_plans_route_to_the_linear_loop_and_the_deep_box():
    """At 3840x2160: the 189 bilinear plans on ``bilinear128.cu`` in
    P8-linear, the 151 0h plans (up and down) in its ROLL and the 38 1h and
    2h ladders in its LOOP; the 11 box x box plans below 0.125x on
    ``deep.cu`` in P8-linear; nothing on ``bilinear.cu`` or ``box.cu``."""
    routes = [(stt.ScalePlan(*a), torch_ops.whole_kernel(stt.ScalePlan(*a))) for a in PLANS]
    wide = [p for p, k in routes if k is bilinear128]
    boxes = [p for p, k in routes if k is deep]
    assert (len(wide), len(boxes)) == (189, 11)
    assert not [k for _, k in routes if k in (bilinear, box)]
    assert all(deep.mode(p) == deep.P8_LINEAR for p in wide + boxes)
    rolled = [p for p in wide if bilinear128.form(p) == bilinear128.ROLL]
    assert all(bilinear128.rolls(p) == (p.y.halvings == 0) for p in wide)
    assert all(bilinear128.form(p) == bilinear128.LOOP for p in wide if p not in rolled)
    assert (len(rolled), len(wide) - len(rolled)) == (151, 38)
    assert [p.width_out for p in boxes] == [a[2] for a in PLANS[:11]]
    assert {(p.x.halvings, p.y.halvings) for p in wide} == {(0, 0), (1, 1), (2, 2)}


def test_modes_are_the_kernels_enum():
    enum = (ROOT / "smolscale_tpu_torch" / "csrc" / "pixels.cuh").read_text()
    assert ("enum Mode { kP8Compressed = 0, kP8Linear = 1, kP16Compressed = 2, "
            "kP16Linear = 3 };") in enum
    assert [deep.P8_COMPRESSED, deep.P8_LINEAR, deep.P16_COMPRESSED,
            deep.P16_LINEAR] == [0, 1, 2, 3]


@pytest.mark.parametrize("step", range(1, 201))
def test_port_equals_reference(step):
    """Step ``step`` of the sweep from 96x54, a batch of 2 in linear light,
    byte for byte."""
    args = SMALL_PLANS[step - 1]
    g = torch.Generator().manual_seed(2_000 + step)
    x = torch.randint(0, 256, (2, 54, 96, 4), dtype=torch.uint8, generator=g)
    got = stt.scale(stt.ScalePlan(*args), x)
    assert got.shape == (2, args[3], args[2], 4)
    assert torch.equal(got, reference.scale(RefPlan(*args), x))


@pytest.fixture(autouse=True)
def one_thread():
    """One thread of host compute, as a run of the benchmark sets it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(program=stt, traced=False, seed=3_210_987_654):
    """A whole run of the cell's entry from 96x54, all 200 plans, batch 2,
    reporting the cell's metrics, over a window of a second."""
    names = spec.cell_metrics(spec.benchmark(), CELL, traced)
    return harness.run(CELL, SMALL_CELL, SMALL, names, seed, 1.0, traced,
                       torch.device("cpu"), program, time.perf_counter())


@pytest.fixture
def fresh_counters(monkeypatch):
    """The port's counters from zero, so that their totals are one run's."""
    monkeypatch.setattr(timing, "_counts", {})


@pytest.fixture
def records(monkeypatch):
    kept = []

    @dataclasses.dataclass
    class Kept(harness.Record):
        def __post_init__(self):
            kept.append(self)

    monkeypatch.setattr(harness, "Record", Kept)
    return kept


def test_untraced_run_is_correct(fresh_counters):
    res = run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"mpix_per_s", "request_p95_ms", "setup_s"}
    assert res["failed"] == 0 and res["checks"]["images_compared"]["value"] >= 1
    assert timing.counter_totals() == {}


def test_traced_run_counts_the_requests_bytes(fresh_counters, records):
    """Under the profiler the two wrappers count exactly the bytes of the
    window's requests; with no card no kernel ran, so the per-kernel
    rooflines find nothing to read."""
    res = run(traced=True)
    assert res["correct"], res["checks"]
    (record,) = records
    got = timing.counter_totals()
    assert set(got) <= {"bilinear128", "deep"}
    assert sum(got.values()) == sum(b for _, b in record.work) > 0
    assert counters.device_s(record, "deep_kernel") == 0
    assert "deep_roofline_pct" not in res["metrics"]
    assert "bilinear128_roofline_pct" not in res["metrics"]


def test_the_control_is_caught():
    """The reference in float32 in the program's place comes out not
    correct."""
    res = run(program=control)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_byte_diff"]["value"] > 0


def test_deep_roofline_reads_nothing_without_counters(monkeypatch):
    monkeypatch.delattr(timing, "counter_totals")
    assert counters.bytes_of("deep") is None
    record = harness.Record("x", 0.0, 1.0, [], [], [], None, None)
    assert spec.metric("deep_roofline_pct").read(record) is None


def test_deep_roofline_reads_the_deep_kernels_time(monkeypatch):
    """Counted bytes at 3.35 TB/s over the summed time of every
    ``deep_kernel`` instance, and nothing of other kernels."""
    from portbench import trace

    monkeypatch.setattr(counters, "bytes_of", lambda name: {"deep": 3.35e9}.get(name))
    summary = trace.Summary(10.0, 5.0, 5.0, [["deep_kernel<1, 0, 1>", 0.002],
                                             ["deep_kernel<1, 0, 2>", 0.002],
                                             ["bilinear128_kernel<2, 2, 1, 0, 0>", 4.0]], [], 3)
    record = harness.Record("x", 0.0, 10.0, [], [], [], 1, summary)
    assert spec.metric("deep_roofline_pct").read(record) == pytest.approx(25.0)
