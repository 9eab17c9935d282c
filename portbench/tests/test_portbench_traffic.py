"""The generator against the port's own rules: the frames-2160p step rule
against ``cli.py benchmark``'s, the 5b fleet's sub-batches against
``scale_pyramid_mixed``'s grouping and padding, and the byte counts and
percentile arithmetic the metrics use."""

import argparse
import json
import math
import statistics

import numpy as np
import pytest
import torch

from portbench import entries, spec, stats, traffic


def _frames():
    return spec.config(spec.benchmark(), "frames-2160p")["frames"]


def _fleet():
    return spec.config(spec.benchmark(), "fleet-5b")["fleet"]


def test_step_rule_matches_cli_benchmark(monkeypatch):
    from smolscale_tpu_torch import cli

    seen = []
    monkeypatch.setattr(cli, "_bench_one",
                        lambda plan, device, reps=5: seen.append(plan.key) or 1e9)
    args = argparse.Namespace(width=3840, height=2160, steps=200, min_scale=0.01, max_scale=2.0,
                              ptype=0, srgb=False, device="cpu", reps=1, samples=None, plot=None)
    assert cli.cmd_benchmark(args) == 0
    assert traffic.frame_plans(_frames()) == seen
    assert len(seen) == 200 and seen[-1][2:4] == (7680, 4320)


def test_cycle_order_is_a_seeded_permutation():
    a, b = traffic.cycle_order(200, 2**33 + 1), traffic.cycle_order(200, 2**33 + 1)
    assert np.array_equal(a, b) and sorted(a) == list(range(200))
    assert not np.array_equal(a, traffic.cycle_order(200, 2**33 + 2))


@pytest.mark.parametrize("seed", [0, 7, 3_123_456_789])
def test_fleet_sub_batches_match_scale_pyramid_mixed(monkeypatch, seed):
    """The farm's own grouping, on the 10,000-image fleet at its sizes (the
    images are broadcast views, the pyramid functions record their batch)."""
    from smolscale_tpu_torch import pyramid

    fleet = _fleet()
    images = traffic.fleet_images(fleet, seed)
    keys = [(traffic.image_shape(fleet["groups"][g]), int(fleet["groups"][g]["pixel_type"]))
            for g, _ in images]
    calls = []

    def fake_fn(w, h, pt, sizes, **kw):
        def fn(x):
            calls.append(((h, w, 3 if pt >= 8 else 4), int(pt), x.shape[0]))
            return tuple(torch.zeros((x.shape[0], 1, 1, 1), dtype=torch.uint8) for _ in sizes)
        return fn

    monkeypatch.setattr(pyramid, "make_pyramid_fn", fake_fn)
    monkeypatch.setattr(pyramid.np, "stack", lambda arrs: np.zeros((len(arrs), 1, 1, 1), np.uint8))
    blank = {k: np.broadcast_to(np.zeros(1, np.uint8), k[0]) for k in set(keys)}
    pyramid.scale_pyramid_mixed([blank[k] for k in keys], [k[1] for k in keys],
                                max_batch_bytes=201326592, device="cpu")
    ours = traffic.sub_batches(keys, 201326592)
    assert [(k[0], k[1], size) for k, _, size in ours] == calls
    assert sorted(i for _, idx, _ in ours for i in idx) == list(range(10_000))
    assert len(ours) == 48
    # padded images: 72 + 112 + 36 + 48 + 205
    assert sum(size - len(idx) for _, idx, size in ours) == 473


def test_fleet_group_counts():
    fleet = _fleet()
    assert traffic.group_counts(fleet) == [3000, 2000, 1500, 2000, 1500]
    images = traffic.fleet_images(fleet, 5)
    assert images == traffic.fleet_images(fleet, 5) != traffic.fleet_images(fleet, 6)
    assert sorted(images) == sorted(traffic.fleet_images(fleet, 6))


def test_fleet_work_counts_real_images():
    """A sweep moves 2,449 Mpx in and 860 Mpx out: 9.27 GB in, 3.27 GB out."""
    fleet = _fleet()
    counts = traffic.group_counts(fleet)
    shapes = [traffic.image_shape(g) for g in fleet["groups"]]
    px_in = sum(n * traffic.pixels(s) for n, s in zip(counts, shapes))
    px_out = 10_000 * (64 * 64 + 128 * 128 + 256 * 256)
    b_in = sum(n * traffic.pixels(s) * s[2] for n, s in zip(counts, shapes))
    b_out = sum(n * (64 * 64 + 128 * 128 + 256 * 256) * s[2] for n, s in zip(counts, shapes))
    assert (px_in, px_out) == (2_449_408_000, 860_160_000)
    assert round(b_in / 1e9, 2) == 9.27 and round(b_out / 1e9, 2) == 3.27

    class Stub(entries.PyramidSweep):
        def __init__(self):
            self.keys = [(s, int(g["pixel_type"])) for s, g in zip(shapes, fleet["groups"])]
            self.sizes = (64, 128, 256)

    stub = Stub()
    work = [stub.image_work(g) for g, _ in traffic.fleet_images(fleet, 3)]
    assert sum(p for p, _ in work) == px_in + px_out
    assert sum(b for _, b in work) == b_in + b_out


def test_frames_work_counts():
    entry = entries.Frames.__new__(entries.Frames)
    entry.args = [(3840, 2160, 7680, 4320, 0, 0, False)]
    entry.order = np.array([0])
    entry.batch, entry.single = 8, False
    assert entry.work(0) == (8 * (3840 * 2160 + 7680 * 4320), 8 * 4 * (3840 * 2160 + 7680 * 4320))


def test_percentile_and_spread():
    vals = [float(v) for v in range(1, 101)]
    assert stats.percentile(vals, 95) == pytest.approx(np.percentile(vals, 95))
    assert stats.percentile([5.0], 95) == 5.0 and stats.percentile([], 95) is None
    rng = np.random.default_rng(0)
    for _ in range(20):
        xs = list(rng.exponential(size=int(rng.integers(2, 500))))
        assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    q1, q2, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 10.0], n=4)
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 10.0]) == pytest.approx((q3 - q1) / q2)
    assert math.isinf(stats.spread([0.0, 0.0, 0.0]))


def test_sample_is_seeded_and_bounded():
    a = traffic.sample(1000, 5, 11)
    assert a == traffic.sample(1000, 5, 11) and len(a) == 5 and max(a) < 1000
    assert traffic.sample(3, 5, 11) == {0, 1, 2}


def test_stats_cli_reads_result_lines(tmp_path, capsys):
    lines = [json.dumps({"cell": "c", "metrics": {"m": {"value": v, "unit": "s"}}})
             for v in (1.0, 2.0, 3.0, 4.0)]
    path = tmp_path / "runs.txt"
    path.write_text("noise\n" + "\n".join(lines) + "\n")
    assert stats.main([str(path)]) == 0
    assert "c m: n=4" in capsys.readouterr().out
