"""Every cell, configuration and metric is found by name and parses, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def test_top_level_and_sizes():
    assert set(BENCH) == TOP_KEYS
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 * 24 runs, each run_seconds + 60,
    # 2 x 90 s of compile per cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_parse(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("portbench/configs/")
    body = spec.config(BENCH, cfg["name"])
    assert body["name"] == cfg["name"] and body["reduced"] == cfg["reduced"]
    assert not any(WIDTHS.search(k) for k in cfg["reduced"])
    assert ("frames" in body) != ("fleet" in body)
    for text in (cfg["source"], cfg["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_find_their_files(cell):
    from portbench.entries import ENTRIES

    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    w = spec.workload(cell["name"])
    assert w["config"] == cell["config"] and w["entry"] in ENTRIES
    assert int(w["check_requests"]) >= 1
    e2e = spec.cell_metrics(BENCH, cell["name"], trace=False)
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.cell_metrics(BENCH, cell["name"], trace=True)
    assert per_layer
    for m in BENCH["per_layer"]:
        if m["name"] in per_layer:
            assert m["moves"] in e2e


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"] + BENCH["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_match_benchmark(m):
    reader = spec.metric(m["name"])
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["unit"] == reader.UNIT and m["better"] == reader.BETTER
    assert m["source"] == reader.SOURCE
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["layer"] == reader.LAYER and m["moves"] == reader.MOVES
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
        spec.cell(BENCH, cell)


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_file_added_by_name_is_found(tmp_path, monkeypatch):
    """A later cell is a workload file and an entry: nothing else changes."""
    monkeypatch.setattr(spec, "HERE", tmp_path)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "workloads" / "new-cell.json").write_text(json.dumps({"config": "c"}))
    reader = ('LAYER = "l"\nUNIT = "ms"\nBETTER = "lower"\nSOURCE = "host_clock"\n'
              'MOVES = "mpix_per_s"\n\n\ndef read(record):\n    return 1.0\n')
    (tmp_path / "metrics" / "new_metric.x.py").write_text(reader)
    (tmp_path / "metrics" / "new_metric.py").write_text(reader)
    assert spec.workload("new-cell") == {"config": "c"}
    assert spec.metric("new_metric.x").read(None) == 1.0
    grouped = spec.metric("new_metric.y")  # no file: new_metric's reader, its group's MOVES
    assert grouped.read(None) == 1.0 and grouped.MOVES == "mpix_per_s.y"
    with pytest.raises(KeyError):
        spec.metric("absent")
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "workloads": ["new-cell"]}]}
    assert spec.cell_metrics(bench, "new-cell", trace=False) == ["a"]
    assert spec.cell_metrics(bench, "new-cell", trace=True) == ["p"]
