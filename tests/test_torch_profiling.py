"""The port's utils/profiling.py against the JAX package's: the step timer's
warmup and summary keys, the roofline numbers (equal to JAX's for the same
peaks; H100 SXM peaks by default), a torch.profiler trace written as a
Chrome trace, and the host lock."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msnv_tpu.utils import profiling as jprof
from msnv_tpu_torch.utils import profiling as tprof


def test_step_timer_warmup_and_summary():
    t = tprof.StepTimer(warmup=2)
    for _ in range(5):
        with t:
            pass
    s = t.summary()
    assert s["n"] == 3                       # warmup steps discarded
    assert set(s) == {"mean_s", "p50_s", "p95_s", "n"}
    assert s["p95_s"] >= s["p50_s"] >= 0.0
    assert tprof.StepTimer().summary() == {}  # no completed steps yet
    # the same keys as the JAX timer's
    j = jprof.StepTimer(warmup=0)
    with j:
        pass
    assert set(j.summary()) == set(s)


def test_step_timer_sync_synchronizes_the_device(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    t = tprof.StepTimer(warmup=0, sync=True)
    with t:
        pass
    with tprof.StepTimer(warmup=0):
        pass
    assert len(calls) == 1 and t.summary()["n"] == 1


@pytest.mark.parametrize("flops,bytes_moved,wall", [
    (394e12, 819e9, 1.0), (1e9, 0.0, 1.0), (3.1e11, 2.5e9, 0.004)])
def test_roofline_equals_jax_for_the_same_peaks(flops, bytes_moved, wall):
    peaks = {"peak_flops": 394e12, "peak_bw": 819e9}
    got = tprof.roofline(flops, bytes_moved, wall, **peaks)
    want = jprof.roofline(flops, bytes_moved, wall, **peaks)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)


def test_roofline_defaults_are_the_h100_peaks():
    r = tprof.roofline(flops=989e12, bytes_moved=3.35e12, wall_s=1.0)
    np.testing.assert_allclose(r["flops_util"], 1.0)
    np.testing.assert_allclose(r["bw_util"], 1.0)
    np.testing.assert_allclose(r["achieved_tflops"], 989.0)
    np.testing.assert_allclose(r["achieved_gbps"], 3350.0)
    np.testing.assert_allclose(r["arithmetic_intensity"], 989e12 / 3.35e12)
    assert tprof.roofline(1e9, 0.0, 1.0)["arithmetic_intensity"] == 1e9


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with tprof.trace(d):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    found = glob.glob(os.path.join(d, "*.json"))
    assert len(found) == 1, f"no trace under {d}"
    with open(found[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_chip_lock_is_a_host_flock(tmp_path):
    """A second process waits for the lock until the first one exits."""
    lock = str(tmp_path / "chip.lock")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, time; from msnv_tpu_torch.utils.profiling import "
            "acquire_chip_lock; acquire_chip_lock(sys.argv[1]); "
            "print('held', flush=True); time.sleep(float(sys.argv[2]))")
    env = {**os.environ, "PYTHONPATH": repo}
    procs = []

    def start(hold):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, lock, hold],
            stdout=subprocess.PIPE, text=True, env=env))
        return procs[-1]

    try:
        first = start("600")
        assert first.stdout.readline().strip() == "chip lock acquired"
        second = start("0")
        assert second.stdout.readline().startswith("waiting for the chip "
                                                   "lock")
        first.kill()
        first.wait(timeout=60)
        out, _ = second.communicate(timeout=120)
        assert out.split() == ["chip", "lock", "acquired", "held"]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
