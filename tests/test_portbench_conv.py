"""The benchmark's format-conversion cell (``conv-2160p``, ``conv2160-b64``)
on the CPU: the configuration's plans, the port against
``portbench/reference`` on each of the 100 pixel-type pairs, the routing of
the pairs to the kernels, and whole harness runs of the cell's entry at a
small size, with the port's byte counters that the per-kernel rooflines
read."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

import smolscale_tpu_torch as stt
from portbench import counters, harness, spec, traffic
from portbench.reference import scale as reference
from portbench.reference.plan import ScalePlan as RefPlan
from smolscale_tpu_torch.backends import torch_ops
from smolscale_tpu_torch.ops import bilinear, bilinear128
from smolscale_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs" / "conv-2160p.json").read_text())
WORKLOAD = json.loads((ROOT / "portbench" / "workloads" / "conv2160-b64.json").read_text())
PAIRS = [(a, b) for a in range(10) for b in range(10)]
UNASSOCIATED = range(4, 8)
# the cell's frames at 64x36: the same one-step rule gives 63x35
SMALL = {"frames": {**CONFIG["frames"], "width": 64, "height": 36}}
SMALL_CELL = {**WORKLOAD, "batch": 4, "resident_frames": 8}


def test_the_configuration_is_upstreams_matrix():
    frames = CONFIG["frames"]
    assert traffic.frame_sizes(frames) == [(3839, 2159)]
    plans = traffic.frame_plans(frames)
    assert len(plans) == 100
    assert sorted((a[4], a[5]) for a in plans) == PAIRS
    assert all(a[:4] == (3840, 2160, 3839, 2159) and a[6] is False for a in plans)
    assert traffic.frame_sizes(SMALL["frames"]) == [(63, 35)]
    assert CONFIG["reduced"] == []


def test_the_cell_is_in_the_benchmark():
    bench = spec.benchmark()
    cell = spec.cell(bench, "conv2160-b64")
    assert cell["config"] == "conv-2160p" and cell["chips"] == 1
    assert spec.config(bench, "conv-2160p") == CONFIG
    assert spec.workload("conv2160-b64") == WORKLOAD
    assert (WORKLOAD["batch"], WORKLOAD["resident_frames"]) == (64, 64)
    assert set(spec.cell_metrics(bench, "conv2160-b64", False)) == {
        "mpix_per_s", "request_p95_ms", "setup_s"}
    assert {"bilinear_roofline_pct", "bilinear128_roofline_pct", "kernel_roofline_pct",
            "device_idle_pct"} <= set(spec.cell_metrics(bench, "conv2160-b64", True))


def test_the_pairs_route_to_bilinear_and_bilinear128():
    """84 pairs on ``bilinear.cu``; the 16 unassociated -> unassociated
    ones (PREMUL16) on ``bilinear128.cu``."""
    routes = {(a[4], a[5]): torch_ops.whole_kernel(stt.ScalePlan(*a))
              for a in traffic.frame_plans(CONFIG["frames"])}
    wide = {p for p, k in routes.items() if k is bilinear128}
    assert wide == {(a, b) for a in UNASSOCIATED for b in UNASSOCIATED}
    assert all(k is bilinear for p, k in routes.items() if p not in wide)
    assert len(routes) - len(wide) == 84


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_port_equals_reference(pair):
    """64x36 -> 63x35, a batch of 2, byte for byte."""
    args = traffic.frame_plans({**SMALL["frames"], "pixel_types": [list(pair)]})[0]
    g = torch.Generator().manual_seed(1_000 + 10 * pair[0] + pair[1])
    x = torch.randint(0, 256, (2, 36, 64, 3 if pair[0] >= 8 else 4), dtype=torch.uint8,
                      generator=g)
    got = stt.scale(stt.ScalePlan(*args), x)
    assert got.shape == (2, 35, 63, 3 if pair[1] >= 8 else 4)
    for b in range(2):
        assert torch.equal(got[b], reference.scale(RefPlan(*args), x[b]))


@pytest.fixture(autouse=True)
def one_thread():
    """One thread of host compute, as a run of the benchmark sets it
    (``portbench.run``): beside other test processes, torch's default
    threads slow the plain versions many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pass_seconds() -> float:
    """The seconds that one pass over the small cell's 100 plans takes now."""
    plans = [stt.ScalePlan(*a) for a in traffic.frame_plans(SMALL["frames"])]
    x = {nb: torch.zeros((SMALL_CELL["batch"], 36, 64, nb), dtype=torch.uint8) for nb in (3, 4)}
    t0 = time.perf_counter()
    for p in plans:
        stt.scale(p, x[p.meta_in.n_bytes])
    return time.perf_counter() - t0


def run(traced=False, seed=3_123_456_789):
    """A whole run of the cell's entry at 64x36, all 100 pairs, batch 4,
    reporting the cell's metrics, over a window of about three passes of
    the pairs, so that every pair's first request is in it."""
    names = spec.cell_metrics(spec.benchmark(), "conv2160-b64", traced)
    return harness.run("conv2160-b64", SMALL_CELL, SMALL, names, seed, 3 * pass_seconds(),
                       traced, torch.device("cpu"), stt, time.perf_counter())


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


def test_untraced_run_is_correct_and_counts_nothing(fresh_counters):
    res = run()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"mpix_per_s", "request_p95_ms", "setup_s"}
    # every pair's first request keeps one image, and two whole requests
    assert res["attempted"] > 100 and res["checks"]["images_compared"]["value"] >= 100
    assert timing.counter_totals() == {}


def test_traced_run_counts_the_requests_bytes(fresh_counters, records):
    """Under the profiler the wrappers count exactly the bytes of the
    window's requests (``record.work``, what ``kernel_roofline_pct``
    counts): the two per-kernel rooflines use the cell's yardstick."""
    res = run(traced=True)
    assert res["correct"], res["checks"]
    (record,) = records
    got = timing.counter_totals()
    assert set(got) == {"bilinear", "bilinear128"}
    assert got["bilinear"] + got["bilinear128"] == sum(b for _, b in record.work) > 0
    assert counters.bytes_of("bilinear") == got["bilinear"]
    # no card: no kernel ran, so the rooflines find nothing to read
    assert counters.device_s(record, "bilinear_kernel") == 0
    assert "bilinear_roofline_pct" not in res["metrics"]
    assert "bilinear128_roofline_pct" not in res["metrics"]


def _alter_each_image(out):
    out = out.clone()
    flat = out.view(out.shape[0], -1)
    flat[:, flat.shape[1] // 2] ^= 1
    return out


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("pair", [(8, 1), (5, 6)], ids=["bilinear", "bilinear128"])
def test_a_fault_in_one_pair_is_caught_on_every_seed(pair, seed, monkeypatch):
    """One image of every pair's first request is compared in every run:
    a byte altered in one pair's outputs alone fails every seed."""
    impl = torch_ops._scale_fn_impl
    monkeypatch.setattr(torch_ops, "_scale_fn_impl", lambda p, x: (
        _alter_each_image(impl(p, x)) if (p.pixel_type_in, p.pixel_type_out) == pair
        else impl(p, x)))
    res = run(seed=seed)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_byte_diff"]["value"] == 1


def test_counters_read_nothing_from_a_port_without_them(monkeypatch):
    monkeypatch.delattr(timing, "counter_totals")
    assert counters.bytes_of("bilinear") is None
    read = spec.metric("bilinear_roofline_pct").read
    record = harness.Record("x", 0.0, 1.0, [], [], [], None, None)
    assert read(record) is None
