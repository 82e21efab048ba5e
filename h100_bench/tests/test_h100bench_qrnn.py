"""The QRNN-tier train cell: its FLOP and byte counts against shapes worked
by hand, its three readers on a made-up trace (and on a port without the
fo-pool kernel, which has nothing for them to read), and a tiny copy of
the cell on the CPU, through the unchanged harness, driver and reference:
correct as it is, not correct with a fault planted in the port's pool (a
pool that drops the (1 - f) factor, one that starts every chunk from a
zero cell instead of the carried one)."""

import json

import pytest
import torch

import h100bench_tiny as tiny
from h100_bench import flops, flops_qrnn, harness, peaks, trace

CELL = "samplernn_qrnn.train.bf16.b128"
MODEL = json.loads((tiny.REPO / "h100_bench/configs/samplernn_qrnn.json")
                   .read_text())["model"]
ROOT = tiny.REPO / "h100_bench"


def test_train_step_flops_by_hand():
    """A QRNN layer's frame step is its input projection: the GRU's hidden
    projection (2 x 3H x H a layer) comes off every tier step, three
    times (forward and both backward products)."""
    B, L, H = 128, 1040, 1024
    gru = flops.train_step(MODEL, B, L)
    got = flops_qrnn.train_step(MODEL, B, L)
    frames = B * L // 20 + B * L // 80
    assert gru - got == pytest.approx(frames * 3 * 2 * (2 * 3 * H * H))
    assert 2.25e12 < got < 2.26e12


def test_pool_bounds_by_hand():
    # bf16 at T 52, B 128, H 1024: forward 8 B an element (g in, h out),
    # backward 14 (g and dh in, dg out), the (B, H) float32 cells in and
    # out, and one saved cell a block of 8 steps but the first (c0): 6
    n, bh = 52 * 128 * 1024, 4 * 128 * 1024
    fwd = flops_qrnn.pool_bytes(52, 128, 1024, "bfloat16", False)
    bwd = flops_qrnn.pool_bytes(52, 128, 1024, "bfloat16", True)
    assert (fwd, bwd) == (8 * n + 8 * bh, 14 * n + 8 * bh)
    assert flops_qrnn.pool_bytes(8, 128, 1024, "float32", False) == \
        16 * 8 * 128 * 1024 + 2 * bh
    assert flops_qrnn.pool_bound_s(52, 128, 1024, "bfloat16", False) == \
        pytest.approx(fwd / peaks.HBM_BYTES_PER_S)
    pools = flops_qrnn.train_pools(MODEL, 128, 1040, "bfloat16")
    assert sorted(t for t, _ in pools) == [13] * 4 + [52] * 4
    assert sum(b for _, b in pools) * 1e3 == pytest.approx(0.1188, rel=1e-3)


def _window(kernels, raw):
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, kernels=kernels)
    return harness.Window({}, raw.get("steps", 0), 0, raw, summary)


def _ctx():
    config = json.loads((ROOT / "configs/samplernn_qrnn.json").read_text())
    traffic = json.loads((ROOT / "traffic/train.qrnn.bf16.b128.json")
                         .read_text())
    return harness.Context(CELL, config, traffic, 1, torch.device("cpu"),
                           30.0)


RAW = {"steps": 40, "wall_s": 1.0, "batch": 128, "seq_len": 1040,
       "dtype": "bfloat16", "gan": False, "traced_pools": 5 * 8,
       "traced_steps": 5}
KERNELS = {"void fo_pool_fwd<__nv_bfloat16>(__nv_bfloat16 const*)":
           [0.0006, 20],
           "void fo_pool_bwd<__nv_bfloat16>(__nv_bfloat16 const*)":
           [0.0009, 20],
           "void gru_fwd_persistent(float const*)": [0.5, 1],
           "sm90_xmma_gemm_bf16bf16": [0.2, 100]}


def test_readers_on_a_made_up_trace():
    ctx, win = _ctx(), _window(KERNELS, RAW)
    read = {m: harness.load_reader(ROOT, m).read(ctx, win) for m in
            ("fo_pool_roofline.train", "fo_pool_ms_per_step.train",
             "train_mfu.qrnn")}
    bound = 5 * sum(b for _, b in flops_qrnn.train_pools(
        MODEL, 128, 1040, "bfloat16"))
    assert read["fo_pool_roofline.train"] == pytest.approx(
        100 * bound / 0.0015)
    assert read["fo_pool_ms_per_step.train"] == pytest.approx(0.3)
    assert read["train_mfu.qrnn"] == pytest.approx(
        100 * 40 * flops_qrnn.train_step(MODEL, 128, 1040) / 989e12)


def test_readers_read_nothing_without_the_kernel():
    """A port without the fo-pool kernel: no launches counted, none in the
    trace; an untraced window."""
    ctx = _ctx()
    other = {k: v for k, v in KERNELS.items() if "fo_pool" not in k}
    for win in (_window(other, dict(RAW, traced_pools=0)),
                harness.Window({}, 0, 0, dict(RAW), None)):
        for m in ("fo_pool_roofline.train", "fo_pool_ms_per_step.train"):
            assert harness.load_reader(ROOT, m).read(ctx, win) is None


# the tiny cell's own limits, the full-width cell's keys (no loss_gap): at
# width 32 its bf16 readings sit higher than the full-width cell's (on two
# seeds grad_gap 0.013 and 0.036, grad_diff 0.066 and 0.058, grad_diff_med
# 0.031 and 0.028, update_gap 0.021 and 0.011; the faults read grad_gap
# 12.5 and update_gap 0.13 without (1 - f), grad_gap 0.35 and update_gap
# 0.75 with the cell reset)
TINY_LIMITS = {"grad_gap": 0.1, "grad_diff": 0.2,
               "grad_diff_med": 0.1, "update_gap": 0.1}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny tree and a tiny copy of the QRNN cell, with its own limits
    and the real cell's metrics."""
    root = tiny.build(tmp_path_factory.mktemp("bench"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    h = root / "h100_bench"
    conf = tiny.shrink(json.loads(
        (h / "configs/samplernn_qrnn.json").read_text()))
    (h / "configs/tiny_qrnn.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny_qrnn", "source": "test",
                             "file": "h100_bench/configs/tiny_qrnn.json",
                             "reduced": [], "why": "test"})
    (h / "traffic/tiny.train.qrnn.json").write_text(json.dumps(
        dict(tiny.TRAFFIC["tiny.train.bf16"], driver="train_qrnn")))
    bench["workloads"].append({"name": "tiny_qrnn.train",
                               "config": "tiny_qrnn",
                               "traffic": "tiny.train.qrnn", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny_qrnn.train")
    (h / "limits/tiny_qrnn.train.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in TINY_LIMITS.items()}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _no_one_minus_f(monkeypatch):
    """c_t = f c_{t-1} + z: the pool without its (1 - f) factor."""
    import msnv_tpu_torch.ops.qrnn as q

    def pool(g, c0):
        H = c0.shape[-1]
        z = torch.tanh(g[..., :H].float())
        f = torch.sigmoid(g[..., H:2 * H].float())
        o = torch.sigmoid(g[..., 2 * H:].float())
        c, hs = c0.float(), []
        for t in range(g.shape[1]):
            c = f[:, t] * c + z[:, t]
            hs.append(o[:, t] * c)
        return torch.stack(hs, 1).to(g.dtype), c

    monkeypatch.setattr(q, "fo_pool", pool)


def _cell_reset_each_chunk(monkeypatch):
    """Every chunk's pool starts from a zero cell, not the carried one."""
    import msnv_tpu_torch.ops.qrnn as q
    orig = q.fo_pool
    monkeypatch.setattr(q, "fo_pool",
                        lambda g, c0: orig(g, torch.zeros_like(c0)))


def _run(root, trace_on=False):
    torch.manual_seed(0)
    return harness.run_cell("tiny_qrnn.train", tiny.SEED, 0.5, trace_on,
                            "cpu", root)


def test_sound_run_is_correct(root):
    out = _run(root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"setup_s", "train_samples_per_s"}
    out = _run(root, trace_on=True)
    # on the CPU the pool launches no kernel: its readers read nothing
    assert set(out["metrics"]) == {"optim_ms_per_step.train",
                                   "train_mfu.qrnn"}


@pytest.mark.parametrize("fault", [_no_one_minus_f, _cell_reset_each_chunk])
def test_fault_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(root)
    assert not out["correct"], out["checks"]
