"""The yardstick's arithmetic: tails over every sample, rates over the whole
window, the idle share from a trace, the FLOP and byte counts against
shapes worked by hand."""

import json

import pytest

import h100bench_tiny as tiny
from h100_bench import flops, peaks, stats, trace

CANON = json.loads((tiny.REPO / "h100_bench/configs/samplernn.json")
                   .read_text())["model"]
GAN = json.loads((tiny.REPO / "h100_bench/configs/samplernn_gan.json")
                 .read_text())["model"]


def test_percentile_is_over_every_value():
    # one slow stream among many fast: its gaps all count, not its median
    gaps = [0.02] * 90 + [0.5] * 10
    assert stats.percentile(gaps, 95) == pytest.approx(0.5)
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert stats.percentile([1.0, float("inf")], 95) == float("inf")


def test_rate_is_over_the_whole_window():
    # three calls of 1024 audio-s in 7.5 s, whatever each call took
    assert stats.rate(3 * 1024.0, 7.5) == pytest.approx(409.6)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_idle_share_from_a_trace():
    ev = [trace.Event("k1", True, 0.0, 1.0),
          trace.Event("k2", True, 0.5, 2.0),       # overlaps k1
          trace.Event("k1", True, 3.0, 4.0),
          trace.Event("aten::mm", False, 0.0, 0.1),
          trace.Event("cudaLaunchKernel", False, 1.9, 1.95),
          trace.Event("cudaStreamSynchronize", False, 2.5, 2.6)]
    s = trace.summarize(ev, 5.0)
    assert s.busy_s == pytest.approx(3.0)
    assert s.kernels["k1"] == [pytest.approx(2.0), 2]
    # the gap 2.0-3.0 follows the last host event begun before it
    assert s.idle_by_host == {"cudaLaunchKernel": pytest.approx(1.0)}
    b = s.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(2.0)]
    assert s.kernel_time(lambda n: n.startswith("k")) == \
        (pytest.approx(3.5), 3)


def test_generation_flops_by_hand():
    dim, q, fs0 = 1024, 256, 20
    mlp = fs0 * dim + 2 * dim * dim + 2 * dim * q
    gru2 = 2 * (2 * 3 * dim * dim + 2 * 3 * dim * dim)   # two layers
    tier0 = 2 * 20 * dim + gru2 + 2 * dim * 20 * dim
    tier1 = 2 * 80 * dim + gru2 + 2 * dim * 4 * dim + 2 * 86 * dim
    want = mlp + tier0 / 20 + tier1 / 80
    assert flops.forward_per_sample(CANON) == pytest.approx(want)
    assert 6.3e6 < want < 6.5e6


def test_train_step_flops_by_hand():
    B, L, dim = 128, 1040, 1024
    n = B * L
    mlp = 2 * dim * dim + 2 * dim * 256
    got = flops.train_step(CANON, B, L)
    fwd = n * flops.forward_per_sample(CANON)
    # about three forwards (the inputs' layers need no input gradient),
    # and the fused table's three products
    assert 2.9 * fwd < got - 3 * flops.table_flops(CANON) < 3.0 * fwd
    assert got > 3 * n * mlp
    # the GAN step's discriminator: 3 x 3.82 TFLOP forward, less the first
    # conv's input gradient
    disc = flops.disc_flops(64, 13, 50, 512)
    assert disc == pytest.approx(2 * 64 * 13 * 50 * 25
                                 * (512 + 7 * 512 * 512))
    gan = flops.train_step(GAN, 64, L, 512) - flops.train_step(GAN, 64, L)
    assert gan == pytest.approx(3 * disc - 2 * 64 * 13 * 50 * 25 * 512)
    assert 11.4e12 < gan < 11.5e12


def test_kernel_bounds_by_hand():
    # K1 at B 1024 in bf16 is bound by its operations: 0.0547 ms
    ops = 1024 * 20 * (2 * (1024 * 1024 + 1024 * 256) + 20 * 1024)
    got = flops.window_bound_s(1024, 20, 256, 1024, "bfloat16")
    assert got == pytest.approx(ops / peaks.BF16_FLOPS)
    assert got * 1e3 == pytest.approx(0.05471, rel=1e-3)
    # K2 float32 at T 52, B 128: 0.2538 ms of split-TF32 operations
    got = flops.gru_sweep_bound_s(52, 128, 1024, "float32", False)
    assert got * 1e3 == pytest.approx(0.2538, rel=1e-3)
    # K2 bf16 at T 52, B 128, forward: bound by bytes, 0.0590 ms
    got = flops.gru_sweep_bound_s(52, 128, 1024, "bfloat16", False)
    assert got * 1e3 == pytest.approx(0.0590, rel=2e-3)
    sweeps = flops.train_sweeps(CANON, 128, 1040, "float32")
    assert sorted(t for t, _ in sweeps) == [13] * 4 + [52] * 4


def test_peaks():
    assert peaks.peak_flops("bfloat16") == 989e12
    assert peaks.peak_flops("float32") == pytest.approx(165e12)
    assert peaks.HBM_BYTES_PER_S == 3.35e12
