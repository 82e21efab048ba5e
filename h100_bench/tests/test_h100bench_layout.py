"""Every cell, configuration, traffic mix, limit and metric of
BENCHMARK.json is a file found by its name, and a cell and a metric added as
files alone (with their entries) are taken up with no other edit."""

import json
import re

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import harness

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
ROOT = tiny.REPO / "h100_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    w, conf = harness.find_cell(BENCH, cell)
    config = harness.load_json(tiny.REPO / conf["file"])
    traffic = harness.load_json(ROOT / "traffic" / f"{w['traffic']}.json")
    driver = harness.load_driver(ROOT, traffic["driver"])
    assert hasattr(driver, "Driver")
    limits = harness.load_json(ROOT / "limits" / f"{cell}.json")
    assert limits and all("limit" in v for v in limits.values())
    assert set(config["model"]) >= {"frame_sizes", "dim", "q_levels"}
    assert w["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers(metric):
    assert callable(harness.load_reader(ROOT, metric).read)


def test_contract_shape():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"setup_s", "audio_s_per_s", "first_audio_p95_ms",
                   "chunk_gap_p95_ms", "train_samples_per_s"}
    names = [x["name"] for x in BENCH["workloads"] + BENCH["configs"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == \
        len(names)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  harness.metric_names(BENCH, cell, False)}
    for cell in BENCH["workloads"]:
        assert harness.metric_names(BENCH, cell["name"], True)
        assert len(harness.metric_names(BENCH, cell["name"], False)) >= 2
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_cell_and_metric_are_files_alone(tmp_path):
    """A new traffic mix, limits file and per-layer reader, with their
    entries in BENCHMARK.json, run through the unchanged harness."""
    root = tiny.build(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    traffic = dict(tiny.TRAFFIC["tiny.gen"], batch=2, frames=4,
                   check_lanes_per_call=2)
    (root / "h100_bench/traffic/new.gen.json").write_text(
        json.dumps(traffic))
    (root / "h100_bench/limits/tiny.new.json").write_text(json.dumps(
        {"gap": {"limit": 1.0}, "bad_audio": {"limit": 0}}))
    (root / "h100_bench/metrics/calls_per_s.new.py").write_text(
        "def read(ctx, win):\n"
        "    return win.attempted / win.raw['wall_s']\n")
    bench["workloads"].append({"name": "tiny.new", "config": "tiny",
                               "traffic": "new.gen", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("tiny.new")
    bench["per_layer"].append({
        "name": "calls_per_s.new", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "generation",
        "moves": "audio_s_per_s", "workloads": ["tiny.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    torch.manual_seed(0)
    out = harness.run_cell("tiny.new", tiny.SEED, 0.5, True, "cpu", root)
    # a per-layer metric reports in the cells its entry lists
    assert set(out["metrics"]) == {"calls_per_s.new"}
    assert out["metrics"]["calls_per_s.new"]["value"] > 0
    assert out["correct"], out["checks"]
    out = harness.run_cell("tiny.new", tiny.SEED, 0.5, False, "cpu", root)
    assert set(out["metrics"]) == {"setup_s", "audio_s_per_s"}
    assert list(out)[-1] == "checks"
