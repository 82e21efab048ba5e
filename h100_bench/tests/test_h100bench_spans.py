"""The per-layer metrics read from the port's spans (utils/profiling.py):
every one reports in a traced run of its tiny cell on the CPU, and each
reads nothing, without raising, from a port that records no spans."""

import json

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import harness

SPAN_METRICS = {
    "tiny.stream": ["mux_push_ms_per_tick.stream",
                    "mux_wait_ms_per_tick.stream",
                    "mux_deliver_ms_per_tick.stream",
                    "mux_attach_ms_per_tick.stream",
                    "mux_queue_p95_ms.stream",
                    "mux_inflight_p95_ms.stream"],
    "tiny_gan.train": ["optim_ms_per_step.train", "disc_ms_per_step.train"],
    "tiny.train": ["optim_ms_per_step.train"],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.build(tmp_path_factory.mktemp("bench"))
    # trace most of a 2 s window, so that streams arrive and start in it
    path = root / "h100_bench" / "traffic" / "tiny.stream.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps(dict(traffic, trace_s=1.5)))
    return root


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_span_metrics_report_in_a_traced_run(root, cell, monkeypatch):
    from msnv_tpu_torch.utils import profiling
    if cell == "tiny.stream":
        tiny.mux_on_window_path(monkeypatch)
    profiling.clear()
    torch.manual_seed(0)
    out = harness.run_cell(cell, tiny.SEED, 2.0, True, "cpu", root)
    profiling.clear()
    for name in SPAN_METRICS[cell]:
        assert name in out["metrics"], (name, sorted(out["metrics"]))
        value = out["metrics"][name]
        assert value["unit"] == "ms" and value["value"] > 0, (name, value)
    if cell == "tiny.train":
        assert "disc_ms_per_step.train" not in out["metrics"]
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", sorted(
    {m for names in SPAN_METRICS.values() for m in names}))
def test_span_metric_reads_nothing_without_spans(name, monkeypatch):
    from msnv_tpu_torch.utils import profiling
    profiling.clear()
    reader = harness.load_reader(tiny.REPO / "h100_bench", name)
    assert reader.read(None, None) is None          # no records
    for fn in ("totals", "percentile"):
        monkeypatch.delattr(profiling, fn)
    assert reader.read(None, None) is None          # a port without spans
