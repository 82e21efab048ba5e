"""The port's utils/profiling.py: a torch.profiler trace written as a
Chrome trace with every thread's spans in it, the span ring (spans,
intervals and device sections that record only while a profiler records,
their parents, request ids and readings), the spans of the stream
multiplexer and of the train steps, and the host lock."""

import contextlib
import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import msnv_tpu_torch.serving.mux as mux_mod
from msnv_tpu_torch.config import ModelConfig, TrainConfig
from msnv_tpu_torch.models.discriminator import discriminator_init
from msnv_tpu_torch.models.generate import streaming_fn
from msnv_tpu_torch.models.samplernn import init_params, init_tier_state
from msnv_tpu_torch.training.gan import make_gan_train_step
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.step import make_train_step
from msnv_tpu_torch.tree import tree_leaves
from msnv_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True)
def _empty_ring():
    tprof.clear()
    yield
    tprof.clear()


def _chrome_events(log_dir):
    found = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(found) == 1, f"no trace under {log_dir}"
    with open(found[0]) as f:
        trace = json.load(f)
    return trace["traceEvents"], trace.get("baseTimeNanoseconds", 0)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with tprof.trace(d):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    events, _ = _chrome_events(d)
    assert any(e.get("name") == "aten::mm" for e in events)


def test_no_profiler_no_records(monkeypatch):
    """Without a profiler a span is one flag test: no record, and no
    record_function."""
    def boom(*a, **k):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert not tprof.enabled()
    with tprof.span("a", request=(0, 1)) as rec:
        assert rec is None
        with tprof.section("b", "cpu"), tprof.section("c", "cuda"):
            tprof.interval("d", 0, 10)
    assert tprof.records() == [] and tprof.totals() == {}
    assert tprof.percentile("a", 50) is None


def test_spans_record_count_duration_parent_request(tmp_path):
    with tprof.trace(str(tmp_path)):
        assert tprof.enabled()
        for i in range(3):
            with tprof.span("outer", request=(i, 7)) as outer:
                with tprof.span("inner") as inner:
                    time.sleep(0.002)
            tprof.interval("wait", outer.start_ns, inner.end_ns)
    assert not tprof.enabled()
    totals = tprof.totals()
    assert {k: v[0] for k, v in totals.items()} == {
        "outer": 3, "inner": 3, "wait": 3}
    assert totals["outer"][1] >= totals["inner"][1] >= 3 * 0.002
    recs = tprof.records()
    assert [r.parent for r in tprof.records("inner")] == ["outer"] * 3
    assert [r.parent for r in tprof.records("wait")] == [None] * 3
    assert [r.request for r in tprof.records("outer")] == [
        (0, 7), (1, 7), (2, 7)]
    for r in recs:
        assert r.end_ns >= r.start_ns
        assert r.seconds == pytest.approx((r.end_ns - r.start_ns) * 1e-9)


def test_span_on_a_second_thread_is_in_the_chrome_trace(tmp_path):
    """A thread already running when the profiler starts: its span is in
    the written trace, at the ring's start within 100 us."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(timeout=60)
        with tprof.span("worker.span", request=(3, 1)):
            torch.mm(torch.ones(32, 32), torch.ones(32, 32))
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()
    with tprof.trace(str(tmp_path)):
        go.set()
        assert done.wait(timeout=60)
    thread.join(timeout=60)
    assert not thread.is_alive()
    events, base_ns = _chrome_events(str(tmp_path))
    spans = [e for e in events if e.get("name") == "worker.span"]
    assert len(spans) == 1
    assert spans[0]["tid"] == thread.native_id
    rec, = tprof.records("worker.span")
    assert rec.request == (3, 1) and rec.parent is None
    trace_start_us = spans[0]["ts"] + base_ns * 1e-3
    assert abs(rec.start_ns * 1e-3 - trace_start_us) < 100.0


@pytest.mark.parametrize("kind", ["span", "section"])
def test_a_span_open_when_the_profiler_stops_is_dropped(kind):
    """The profiler's stop can hold other threads for seconds: a span open
    across it would read that hold."""
    prof = torch.profiler.profile()
    prof.__enter__()
    with tprof.span("kept"):
        pass
    opened = (tprof.span("open") if kind == "span"
              else tprof.section("open", "cpu"))
    with opened:
        prof.__exit__(None, None, None)
    assert [r.name for r in tprof.records()] == ["kept"]


@pytest.mark.parametrize("q", [5, 50, 95, 99])
def test_percentile_is_numpys(q):
    rng = np.random.default_rng(q)
    ns = rng.integers(1_000, 50_000_000, 257)
    with torch.profiler.profile():
        for n in ns:
            tprof.interval("x", 1_000, 1_000 + int(n))
    want = np.percentile(ns * 1e-9, q)
    assert tprof.percentile("x", q) == pytest.approx(want, rel=1e-12)
    assert tprof.percentile("y", q) is None


def test_section_is_a_host_span_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", None)   # never reached
    with torch.profiler.profile():
        with tprof.span("step"):
            with tprof.section("train.optim", torch.device("cpu")):
                time.sleep(0.003)
    rec, = tprof.records("train.optim")
    assert rec.parent == "step"
    assert rec.seconds == pytest.approx((rec.end_ns - rec.start_ns) * 1e-9)
    assert rec.seconds >= 0.003


class _FakeEvent:
    """A CUDA event on a fake clock: complete once `done`."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t, self.done, self.syncs = None, False, 0

    def record(self, stream=None):
        self.t, self.done = _FakeEvent.clock, False

    def query(self):
        return self.done

    def synchronize(self):
        self.syncs += 1
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t                 # ms


def test_device_sections_resolve_without_a_synchronize(monkeypatch):
    """A section's pair is read once its end completes, polled at the next
    section; a section still open when the profiler stops is read by the
    reading, which waits for it; the events go back to the pool."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    dev = torch.device("cuda")
    made = []
    with torch.profiler.profile():
        for ms in (5.0, 2.0):
            with tprof.section("s", dev):
                _FakeEvent.clock += ms
        first_end = tprof._pending[0][3]
        assert len(tprof._pending) == 2 and not tprof._ring
        first_end.done = True
        with tprof.section("s", dev):
            _FakeEvent.clock += 1.0
        made.append(_FakeEvent.made)
        assert [r.seconds for r in tprof._ring] == pytest.approx([5e-3])
    assert made == [4]                        # the first pair, reused
    events = [e for _, _, s, t in tprof._pending for e in (s, t)]
    assert sum(e.syncs for e in events) == 0
    assert [r.seconds for r in tprof.records("s")] == pytest.approx(
        [5e-3, 2e-3, 1e-3])
    assert tprof._pending == []


def test_two_threads_lose_no_span():
    n = 10_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile():
            def work(k):
                for _ in range(n):
                    with tprof.span("t", request=k):
                        pass

            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    recs = tprof.records("t")
    assert len(recs) == 2 * n
    assert sorted(r.request for r in recs) == [0] * n + [1] * n
    assert all(r.parent is None for r in recs)


def test_ring_keeps_the_newest():
    with torch.profiler.profile():
        for i in range(tprof.RING + 10):
            tprof.interval("r", i, i + 1)
    recs = tprof.records()
    assert len(recs) == tprof.RING
    assert recs[0].start_ns == 10 and recs[-1].start_ns == tprof.RING + 9


# -- the stream multiplexer ---------------------------------------------------

MUX_CFG = ModelConfig(frame_sizes=(2, 2), n_rnn=1, dim=16, cond_dim=3,
                      cond_len=4, spk_dim=3)
STREAMS, BLOCKS = 3, 8


@pytest.fixture(scope="module")
def mux_run(tmp_path_factory):
    """Three streams of eight blocks through a 4-lane multiplexer on the
    window path, every block fed before the pump starts, all under
    profiling.trace(). -> (the pump's records, the change in ticks, the
    Chrome trace's events)."""
    log_dir = str(tmp_path_factory.mktemp("mux_trace"))
    params = init_params(MUX_CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    rng = np.random.RandomState(0)
    C = MUX_CFG.effective_cond_dim

    def window_path(params, cfg, **kw):
        kw.update(use_kernel=True, compute_dtype=torch.bfloat16)
        return streaming_fn(params, cfg, **kw)

    tprof.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mux_mod, "streaming_fn", window_path)
        mux = mux_mod.StreamMultiplexer(params, MUX_CFG, lanes=4,
                                        frames_per_push=2, seed=3)
        ticks0 = mux.ticks
        with tprof.trace(log_dir):
            lanes = [mux.acquire(s) for s in range(STREAMS)]
            for lane in lanes:
                mux.feed(lane, [rng.rand(2, C).astype(np.float32)
                                for _ in range(BLOCKS)])
            mux.start()
            try:
                for lane in lanes:
                    for _ in range(BLOCKS):
                        mux.out_queue(lane).get(timeout=120)
            finally:
                mux.stop()
            assert not mux._thread.is_alive()
    pump = mux._thread.native_id
    records = {name: tprof.records(name) for name in
               ("mux.push", "mux.attach", "mux.wait", "mux.deliver",
                "mux.queue", "mux.inflight")}
    events, _ = _chrome_events(log_dir)
    tprof.clear()
    return records, mux.ticks - ticks0, events, lanes, pump


def test_mux_spans_count_ticks_and_streams(mux_run):
    records, ticks, events, lanes, pump = mux_run
    assert ticks == BLOCKS
    assert len(records["mux.push"]) == ticks
    for name in ("mux.wait", "mux.deliver", "mux.inflight"):
        assert len(records[name]) == ticks, name
    assert len(records["mux.attach"]) == 1     # one splice, three lanes
    queue = records["mux.queue"]
    assert len(queue) == STREAMS
    assert sorted(r.request for r in queue) == sorted(
        (lane, 1) for lane in lanes)
    first_push = min(r.start_ns for r in records["mux.push"])
    assert all(r.end_ns == first_push for r in queue)
    # the pump's spans are in the Chrome trace, on the pump's thread
    for name in ("mux.push", "mux.wait", "mux.deliver"):
        spans = [e for e in events if e.get("name") == name]
        assert len(spans) == ticks and {e["tid"] for e in spans} == {pump}


def test_mux_inflight_holds_the_later_pushes(mux_run):
    """The card holds at most two ticks: before a tick's delivery ends at
    most one later tick has been pushed, and its time in flight starts at
    its push's end."""
    records = mux_run[0]
    pushes = sorted(records["mux.push"], key=lambda r: r.start_ns)
    flights = sorted(records["mux.inflight"], key=lambda r: r.start_ns)
    assert [f.start_ns for f in flights] == [p.end_ns for p in pushes]
    assert len(pushes) > 2
    for i, flight in enumerate(flights):
        later = [p for p in pushes[i + 1:] if p.start_ns < flight.end_ns]
        assert len(later) <= 1, (i, len(later))
    for r in records["mux.wait"] + records["mux.deliver"]:
        assert r.parent is None


# -- the train steps ----------------------------------------------------------

TRAIN_CFG = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                        cond_len=16, spk_dim=3)
GAN_CFG = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                      cond_len=16, spk_dim=3, variant="gan", ind_cond_dim=6)
TCFG = TrainConfig(seq_len=64, batch_size=4, learning_rate=2e-3,
                   lambda_weight=(0.0, 0.5, 4.0), disc_channels=8)
STEPS = 2


def _batches(cfg):
    g = torch.Generator().manual_seed(11)
    B, L, lb = TCFG.batch_size, TCFG.seq_len, cfg.lookback
    out = []
    for k in range(STEPS):
        win = torch.randint(0, cfg.q_levels, (B, L + lb), generator=g)
        cond = torch.rand((B, L // lb, cfg.effective_cond_dim), generator=g)
        spk = torch.randint(0, cfg.spk_dim, (B,), generator=g)
        out.append((win[:, :-1], k == 0, win[:, lb:], cond, spk))
    return out


def _profiled(on):
    return torch.profiler.profile() if on else contextlib.nullcontext()


def _train(profiled):
    params = init_params(TRAIN_CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    opt = make_optimizer(TCFG)
    opt_state = opt.init(params)
    state = init_tier_state(TRAIN_CFG, TCFG.batch_size, device="cpu")
    step = make_train_step(TRAIN_CFG, opt)
    with _profiled(profiled):
        for batch in _batches(TRAIN_CFG):
            params, opt_state, state, _ = step(params, opt_state, state,
                                               *batch)
    return tree_leaves(params) + tree_leaves(opt_state["mu"])


def _gan(profiled):
    params = init_params(GAN_CFG, torch.Generator().manual_seed(0),
                         device="cpu")
    disc = discriminator_init(torch.Generator().manual_seed(1),
                              GAN_CFG.spk_dim, TCFG.disc_channels,
                              device="cpu")
    opt = make_optimizer(TCFG)
    opt_state, disc_state = opt.init(params), opt.init(disc)
    state = init_tier_state(GAN_CFG, TCFG.batch_size, device="cpu")
    step = make_gan_train_step(GAN_CFG, TCFG, opt, opt)
    with _profiled(profiled):
        for i, batch in enumerate(_batches(GAN_CFG)):
            params, disc, opt_state, disc_state, state, _ = step(
                params, disc, opt_state, disc_state, state, i, *batch)
    return tree_leaves(params) + tree_leaves(disc)


@pytest.mark.parametrize("run,sections", [
    (_train, {"train.optim": STEPS}),
    (_gan, {"train.optim": STEPS, "train.disc": STEPS})],
    ids=["train", "gan"])
def test_train_step_sections_change_no_bit(run, sections):
    plain = run(False)
    assert tprof.records() == []
    traced = run(True)
    assert {k: v[0] for k, v in tprof.totals().items()} == sections
    assert all(r.seconds > 0 for r in tprof.records())
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


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
