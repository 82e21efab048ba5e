"""The cell `single_speaker_cond.stream.mux128`: its place in the layout,
its readers on canned traces and counters, and the cell at a tiny size on
the CPU through the harness, sound and with faults planted. The four-chip
rule of the layout, and the blocked reference that the data-parallel train
driver (drivers/train_mesh.py) checks its ranks against."""

import json
import math

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import flops, harness, trace
from h100_bench.reference import samplernn as ref
from h100_bench.reference import samplernn_blocks
from test_h100bench_faults import GEN_FAULTS

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
ROOT = tiny.REPO / "h100_bench"
COND3 = "single_speaker_cond.stream.mux128"
STREAM = "samplernn.stream.mux128"
NEW = ("tier_step_us.cond3",)


class Ctx:
    def __init__(self, model, traffic=None):
        self.model, self.traffic = model, traffic or {}


def _reader(name):
    return harness.load_reader(ROOT, name).read


def _config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


# -- layout -----------------------------------------------------------------

def test_four_chip_cells_within_a_quarter():
    cells = BENCH["workloads"]
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    for w in four:
        traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert traffic["ranks"] == w["chips"]


@pytest.mark.parametrize("metric", NEW)
def test_new_metric_has_reader_and_cells(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    assert (ROOT / "metrics" / f"{metric}.py").is_file()
    assert entry["workloads"] == [COND3]
    assert callable(_reader(metric))


def test_new_cells_report_their_end_to_end_metrics():
    """The stream cell's end-to-end metrics, and every per-layer metric of
    the two-tier stream cell besides its own."""
    names = {m["name"] for m in harness.metric_names(BENCH, COND3, False)}
    assert names == {"setup_s", "first_audio_p95_ms", "chunk_gap_p95_ms"}
    layer = {m["name"] for m in harness.metric_names(BENCH, COND3, True)}
    stream = {m["name"] for m in harness.metric_names(BENCH, STREAM, True)}
    assert layer == stream | set(NEW)


def test_cond3_config_is_the_preset_uncut():
    from msnv_tpu_torch.config import preset
    conf = _config("single_speaker_cond")
    cfg = harness.model_config(conf["model"])
    want = preset("single_speaker_cond").model
    for key in ("frame_sizes", "n_rnn", "dim", "learn_h0", "q_levels",
                "ulaw", "cond_dim", "cond_len", "spk_dim", "look_ahead",
                "variant", "weight_norm", "qrnn"):
        assert getattr(cfg, key) == getattr(want, key), key
    assert conf["reduced"] == [] and conf["data"]["static_spk"]


# -- readers ----------------------------------------------------------------

def _summary(kernels, window_s=1.0, busy_s=0.9):
    return trace.TraceSummary(window_s=window_s, busy_s=busy_s,
                              kernels=kernels)


def test_tier_step_reader():
    """The traced ticks' steps from the frame sizes: 25 a frame at (4, 5, 4);
    nothing without a trace or a traced tick."""
    kernels = {"window_resident": [2.0, 80],
               "nvjet_tst_72x64_64x12_4x2_h_bz_TNN": [0.6, 400],
               "void at::native::elementwise_kernel<128, 4>(int)": [0.4, 900],
               "Memcpy HtoD (Pinned -> Device)": [0.3, 10],
               "Memset (Device)": [0.1, 2]}
    ctx = Ctx(_config("single_speaker_cond")["model"],
              {"frames_per_push": 4})
    read = _reader("tier_step_us.cond3")
    win = harness.Window({}, 0, 0, {"traced_ticks": 10}, _summary(kernels))
    assert read(ctx, win) == pytest.approx(1e6 * 1.0 / (10 * 4 * 25))
    assert read(ctx, harness.Window({}, 0, 0, {"traced_ticks": 10})) is None
    assert read(ctx, harness.Window({}, 0, 0, {}, _summary(kernels))) is None
    # samplernn's (20, 4): a frame of 80 samples steps the bottom tier 4
    # times and the top one once
    mod = harness.load_reader(ROOT, "tier_step_us.cond3")
    assert mod.steps_per_tick([20, 4], 4) == 4 * (4 + 1)


def test_cond3_readers_read_as_the_stream_cells():
    """The stream cell's readers at the three-tier configuration: K1's
    bound at fs0 4 and dim 512."""
    m = _config("single_speaker_cond")["model"]
    raw = {"ticks": 100, "window_s": 1.2, "traced_launches": 800,
           "window_batch": 128, "window_dtype": "bfloat16"}
    s = _summary({"window_resident": [0.5, 800]}, 3.0, 2.97)
    win = harness.Window({}, 0, 0, raw, s)
    assert _reader("mux_ms_per_tick.stream")(Ctx(m), win) == \
        pytest.approx(12.0)
    assert _reader("device_idle.stream")(Ctx(m), win) == pytest.approx(1.0)
    bound = 800 * flops.window_bound_s(128, 4, 256, 512, "bfloat16")
    assert _reader("k1_window_roofline.stream")(Ctx(m), win) == \
        pytest.approx(100.0 * bound / 0.5)


# -- the blocked reference --------------------------------------------------

def test_blocked_reference_is_one_pass():
    """Two blocks of a batch give one pass's losses, gradient and update
    (float32: the rounding of a mean taken in two parts)."""
    conf = tiny.shrink(_config("samplernn"))
    m, t = conf["model"], conf["train"]
    cfg = harness.model_config(m)
    from msnv_tpu_torch.models.samplernn import init_params
    from h100_bench import inputs
    dev = torch.device("cpu")
    params = inputs.fill_tree(init_params(cfg, device="meta"),
                              inputs.generator(dev, 3, "weights"), dev)
    g = inputs.generator(dev, 3, "corpus")
    L, lb, B = t["seq_len"], cfg.lookback, 4
    q = inputs.audio_levels(g, B, 2 * L + lb, 256, dev)
    cond = inputs.conditioners(g, (B, 2 * L // lb + 2, flops.cond_dim(m)),
                               dev)
    spk = torch.tensor([0, 1, 1, 0])
    chunks = [(q[:, k * L:k * L + L + lb - 1], k == 0,
               q[:, k * L + lb:k * L + lb + L],
               cond[:, k * L // lb + 1:(k + 1) * L // lb + 1], spk)
              for k in range(2)]
    one = ref.train_steps(m, t, params, None, chunks)
    two = samplernn_blocks.train_steps(m, t, params, chunks, 2)
    for a, b in zip(one["loss"], two["loss"]):
        assert math.isclose(a, b, rel_tol=1e-5)
    for key in ("grad", "change"):
        for a, b in zip(one[key], two[key]):
            assert math.isclose(a, b, rel_tol=1e-3, abs_tol=1e-7), key


# -- the three-tier stream cell, tiny, through the harness -----------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree with a cell of the three-tier configuration at width
    32, streamed through the stream_tiers driver, reporting as the real
    cell."""
    dst = tiny.build(tmp_path_factory.mktemp("bench"))
    h = dst / "h100_bench"
    conf = _config("single_speaker_cond")
    conf["model"].update(dim=32, cond_dim=3)
    (h / "configs/tiny3.json").write_text(json.dumps(conf))
    traffic = dict(tiny.TRAFFIC["tiny.stream"], driver="stream_tiers",
                   rate=8.0, trace_s=0.9)
    (h / "traffic/tiny3.stream.json").write_text(json.dumps(traffic))
    (h / "limits/tiny3.stream.json").write_text(
        (ROOT / "limits" / f"{COND3}.json").read_text())
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny3", "source": "test",
                             "file": "h100_bench/configs/tiny3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny3.stream", "config": "tiny3",
                               "traffic": "tiny3.stream", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if COND3 in m.get("workloads", ()):
            m["workloads"].append("tiny3.stream")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


def _run(root, monkeypatch, trace_on=False):
    tiny.mux_on_window_path(monkeypatch)
    torch.manual_seed(0)
    return harness.run_cell("tiny3.stream", tiny.SEED, 1.2, trace_on, "cpu",
                            root)


def test_three_tier_stream_cell_is_correct(root, monkeypatch):
    out = _run(root, monkeypatch)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) >= {"setup_s", "first_audio_p95_ms"}


def test_three_tier_stream_cell_traced(root, monkeypatch):
    """Traced, the driver hands the readers the traced ticks, counted with
    the pump held; on the CPU no kernel runs, so the device readers read
    nothing, and nothing raises."""
    mod = harness.load_driver(root / "h100_bench", "stream_tiers")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w, conf = harness.find_cell(bench, "tiny3.stream")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "h100_bench/traffic/tiny3.stream.json")
                         .read_text())
    tiny.mux_on_window_path(monkeypatch)
    d = mod.Driver(harness.Context("tiny3.stream", config, traffic,
                                   tiny.SEED, torch.device("cpu"), 1.2))
    win = d.window(1.2, True)
    d.finish()
    assert _reader("tier_step_us.cond3")(
        harness.Context("tiny3.stream", config, traffic, tiny.SEED,
                        torch.device("cpu"), 1.2), win) is None
    out = _run(root, monkeypatch, trace_on=True)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(GEN_FAULTS))
def test_three_tier_stream_fault_is_not_correct(root, fault, monkeypatch):
    GEN_FAULTS[fault](monkeypatch)
    out = _run(root, monkeypatch)
    assert not out["correct"], out["checks"]
