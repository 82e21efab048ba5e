"""Live streams through the lane-batched multiplexer (`StreamMultiplexer`),
as `msnv-serve-torch --mux_lanes L --frames_per_push K` builds it, driven
open-loop through its public calls: acquire, set_sink, feed, release.

Streams arrive at `rate` a second over the window. Their inter-arrival
times and lengths are the same for every seed: stratified quantiles of an
exponential and of a lognormal (median `median_s`, `sigma`, clipped to
[min_s, max_s], whole pushes of K frames), put in an order drawn from the
seed; speakers are uniform and conditioners random. A stream's frames are
all fed when it is accepted (the acoustic model runs ahead of the vocoder);
its lane is released when its last chunk has arrived. A stream the
multiplexer refuses (Overloaded) has failed.

first_audio_p95_ms: over every stream that arrived in the window, from its
scheduled arrival to its first audio (a refused or unfinished stream counts
as waiting until the run stopped looking). chunk_gap_p95_ms: over every pair
of consecutive chunks (K frames) of those streams.

The check takes the streams drawn from the seed and the longest one, maps
their PCM back to mu-law levels (`unmatched` counts samples that are no
level's value), and holds every sample to the plain reference along its
sequence from a fresh state, with the kernel's noise of the push that made
it: the multiplexer draws one window seed per window of every push from its
generator, seeded from --seed; a stream's chunks come from consecutive
pushes, the first of which the check finds among the few before the
multiplexer's tick count at its first chunk.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from h100_bench import flops, harness, inputs, stats, trace
from h100_bench.drivers.generate import _port_template, widest
from h100_bench.reference import philox
from h100_bench.reference import samplernn as ref

SEARCH = 16        # pushes before the tick count that may hold a first chunk


@dataclass
class Stream:
    at: float                 # scheduled arrival, s after the window opens
    frames: int
    spk: int
    keep: bool
    lane: int = -1
    refused: bool = False
    times: list = field(default_factory=list)
    pcm: list = field(default_factory=list)
    first_ticks: int = -1
    done: bool = False
    cond: object = None


class Driver:
    def __init__(self, ctx: harness.Context):
        from msnv_tpu_torch.serving.common import Overloaded
        from msnv_tpu_torch.serving.mux import StreamMultiplexer
        from msnv_tpu_torch.kernels import sample_window as sw

        self.ctx, self.sw, self.Overloaded = ctx, sw, Overloaded
        tr, m, dev = ctx.traffic, ctx.model, ctx.device
        self.cfg = harness.model_config(m)
        self.K = tr["frames_per_push"]
        self.params = inputs.fill_tree(
            _port_template(self.cfg),
            inputs.generator(dev, ctx.seed, "weights"), dev)
        self.mux_seed = inputs.derive(ctx.seed, "mux")
        self.mux = StreamMultiplexer(self.params, self.cfg,
                                     lanes=tr["lanes"], frames_per_push=self.K,
                                     temperature=tr["temperature"],
                                     seed=self.mux_seed)
        self.mux.start()
        self.cond_dim = flops.cond_dim(m)
        self._rng = np.random.default_rng(inputs.derive(ctx.seed, "cond"))
        self._done = threading.Condition()
        # every shape of the window, once: one short stream
        warm = Stream(0.0, 2 * self.K, 0, False)
        self._start(warm, self._blocks(warm.frames))
        self._wait([warm], 120.0)
        self.streams = self.schedule(ctx.seconds)
        self.conds = [self._blocks(s.frames) for s in self.streams]

    # -- traffic -----------------------------------------------------------

    def schedule(self, seconds):
        tr = self.ctx.traffic
        rng = np.random.default_rng(inputs.derive(self.ctx.seed, "traffic"))
        n = max(1, round(tr["rate"] * seconds))
        gaps = inputs.stratified(rng, n, lambda u: -np.log1p(-u) / tr["rate"])
        at = np.cumsum(gaps) * seconds / (gaps.sum() + gaps.mean())
        secs = inputs.stratified(
            rng, n, lambda u: np.exp(math.log(tr["median_s"])
                                     + tr["sigma"] * _norm_ppf(u)))
        secs = np.clip(secs, tr["min_s"], tr["max_s"])
        per_push = self.K / (16000.0 / self.cfg.lookback)
        frames = (np.ceil(secs / per_push) * self.K).astype(int)
        spk = rng.integers(0, self.ctx.model["spk_dim"], n)
        keep = set(rng.choice(n, min(n, tr["check_streams"]),
                              replace=False).tolist())
        keep.add(int(np.argmax(frames)))
        return [Stream(float(a), int(f), int(s), i in keep)
                for i, (a, f, s) in enumerate(zip(at, frames, spk))]

    def _blocks(self, frames):
        return self._rng.random((frames, self.cond_dim), dtype=np.float32)

    def _start(self, s: Stream, cond):
        """Accept a stream or mark it refused."""
        try:
            lane = self.mux.acquire(s.spk)
        except self.Overloaded:
            s.refused = True
            return
        s.lane = lane
        n_chunks = s.frames // self.K
        mux = self.mux

        def sink(pcm, s=s):
            if not s.times:
                s.first_ticks = mux.ticks
            s.times.append(time.perf_counter())
            if s.keep:
                s.pcm.append(pcm)
            if len(s.times) == n_chunks:
                mux.release(s.lane)
                with self._done:
                    s.done = True
                    self._done.notify_all()

        mux.set_sink(lane, sink)
        mux.feed(lane, list(cond.reshape(n_chunks, self.K, self.cond_dim)))
        if s.keep:
            s.cond = cond

    def _wait(self, streams, timeout):
        deadline = time.perf_counter() + timeout
        with self._done:
            while not all(s.done or s.refused for s in streams):
                left = deadline - time.perf_counter()
                if left <= 0:
                    return
                self._done.wait(left)

    # -- the window --------------------------------------------------------

    def window(self, seconds, trace_on):
        tr = self.ctx.traffic
        streams, conds = self.streams, self.conds
        span = trace.Span(self.ctx.device) if trace_on else None
        span_at = seconds - tr["trace_s"]
        counts = {}
        t0 = time.perf_counter()
        ticks0, launches0 = self.mux.ticks, self.sw.sample_window.launches
        late = 0.0
        for s, cond in zip(streams, conds):
            now = time.perf_counter()
            if span is not None and not counts and now - t0 >= span_at:
                counts = {"ticks": self.mux.ticks,
                          "launches": self.sw.sample_window.launches}
                span.start()
            due = t0 + s.at
            if due > now:
                time.sleep(due - now)
            late = max(late, time.perf_counter() - due)
            self._start(s, cond)
        left = t0 + seconds - time.perf_counter()
        if left > 0:
            time.sleep(left)
        ticks1 = self.mux.ticks
        t1 = time.perf_counter()
        raw = {"ticks": ticks1 - ticks0, "window_s": t1 - t0,
               "launches": self.sw.sample_window.launches - launches0,
               "window_batch": tr["lanes"], "window_dtype": "bfloat16",
               "generator_late_s": late}
        summary = None
        if span is not None and counts:
            raw["traced_ticks"] = self.mux.ticks - counts["ticks"]
            raw["traced_launches"] = (self.sw.sample_window.launches
                                      - counts["launches"])
            summary = span.stop()
        self._wait(streams, tr["drain_s"])
        t_stop = time.perf_counter()
        per_chunk = self.K * self.cfg.lookback
        raw["samples_served"] = per_chunk * sum(
            1 for s in streams for t in s.times if t0 <= t <= t1)
        first, gaps, failed = [], [], 0
        for s in streams:
            if s.refused or not s.done:
                failed += 1
            if s.times:
                first.append(s.times[0] - (t0 + s.at))
            else:
                first.append(t_stop - (t0 + s.at))
            gaps += list(np.diff(s.times))
        metrics = {"first_audio_p95_ms": 1e3 * stats.percentile(first, 95)}
        if gaps:
            metrics["chunk_gap_p95_ms"] = 1e3 * stats.percentile(gaps, 95)
        return harness.Window(metrics, len(streams), failed, raw, summary)

    def finish(self):
        self.mux.stop()
        self.mux = None

    # -- the check -----------------------------------------------------------

    def check(self, control=None) -> dict:
        """The numbers compared; with `control` ("fp8", "tf32") the
        reference in that precision stands in the program's place (see
        generate.Driver.check)."""
        m, dev = self.ctx.model, self.ctx.device
        q, fs0 = m["q_levels"], m["frame_sizes"][0]
        lookback = self.cfg.lookback
        table = pcm_table(m, dev)
        # a refused stream has failed (the window counts it); an accepted
        # one that never delivered all its chunks is short
        kept = [s for s in self.streams if s.keep and not s.refused]
        short = sum(1 for s in kept if not s.done)
        kept = sorted((s for s in kept if s.done), key=lambda s: s.frames)
        wins = self.K * lookback // fs0            # windows a push
        pushes = max(s.first_ticks + s.frames // self.K for s in kept) \
            if kept else 0
        g = torch.Generator(device=dev).manual_seed(self.mux_seed)
        seeds = philox.window_seeds(g, pushes * wins, dev)
        gap, unmatched = 0.0, 0
        for i in range(0, len(kept), 4):
            group = kept[i:i + 4]
            n = max(s.frames for s in group) * lookback
            seqs, conds = [], []
            for s in group:
                pcm = np.frombuffer(b"".join(s.pcm), dtype="<i2")
                lv, bad = levels_of(pcm, table)
                unmatched += bad
                seqs.append(np.pad(lv, (0, n - lv.size),
                                   constant_values=q // 2))
                conds.append(np.pad(s.cond, ((0, n // lookback - s.frames),
                                             (0, 0))))
            seq = torch.as_tensor(np.stack(seqs), device=dev)
            cond = torch.as_tensor(np.stack(conds), device=dev)
            spk = torch.as_tensor([s.spk for s in group], device=dev)
            logits = ref.generation_logits(m, self.params, seq, cond, spk)
            low = (None if control is None else ref.generation_logits(
                m, self.params, seq, cond, spk, control))
            for j, s in enumerate(group):
                size = s.frames * lookback
                gap = max(gap, stream_gap(
                    logits[j, :size], seq[j, :size], seeds, s, wins, fs0,
                    None if low is None else low[j, :size]))
        if control is not None:
            unmatched = short = 0
        return {"gap": gap, "unmatched": unmatched, "short": short}


def stream_gap(logits, seq, seeds, s: Stream, wins, fs0, control=None):
    """A stream's widest gap (see generate.window_gap) with its first push
    found among the SEARCH before its first chunk's tick count: the one
    whose noise fits its first chunk best. With `control`, the gap of the
    samples that those logits put first."""
    dev = logits.device
    lane = torch.as_tensor([s.lane], device=dev)
    q = logits.shape[-1]
    n_push = seq.shape[0] // (wins * fs0)

    def gaps(n0, chunks, low=None):
        idx = torch.arange(chunks * wins, device=dev) + n0 * wins
        noise = philox.gumbel(seeds[idx], lane, fs0, q).reshape(-1, q)
        size = chunks * wins * fs0
        z = logits[:size] + noise
        got = seq[:size] if low is None else (low[:size] + noise).argmax(-1)
        best = z.max(dim=-1).values
        chosen = torch.gather(z, -1, got[:, None].long())[:, 0]
        return widest(best, chosen)

    lo = max(0, s.first_ticks - SEARCH)
    n0 = min(range(lo, s.first_ticks), key=lambda n: gaps(n, 1))
    return gaps(n0, n_push, control)


def pcm_table(m, device):
    """The PCM16 value of every level, as the multiplexer converts audio."""
    lv = torch.arange(m["q_levels"], device=device)
    audio = ref.dequantize(m, lv).cpu().numpy()
    return (np.clip(audio, -1.0, 1.0 - 1.0 / 32768) * 32768.0).astype("<i2")


def levels_of(pcm, table):
    """Levels whose PCM value lies within 1 of each sample -> (levels,
    count of samples that are no level's value)."""
    t = table.astype(np.int64)
    x = pcm.astype(np.int64)
    i = np.clip(np.searchsorted(t, x), 1, len(t) - 1)
    near = np.where(np.abs(t[i - 1] - x) <= np.abs(t[i] - x), i - 1, i)
    bad = int(np.sum(np.abs(t[near] - x) > 1))
    return near.astype(np.int32), bad


def _norm_ppf(u):
    """The standard normal's quantile function (Acklam's rational
    approximation, relative error below 1.2e-9)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    u = np.asarray(u, dtype=np.float64)
    out = np.empty_like(u)
    lo, hi = u < 0.02425, u > 1 - 0.02425
    mid = ~(lo | hi)
    qm = u[mid] - 0.5
    r = qm * qm
    out[mid] = ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                 * r + a[5]) * qm /
                (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
                 * r + 1))
    for mask, sign in ((lo, 1.0), (hi, -1.0)):
        ql = np.sqrt(-2 * np.log(np.where(sign > 0, u[mask], 1 - u[mask])))
        out[mask] = sign * ((((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3])
                              * ql + c[4]) * ql + c[5]) /
                             ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3])
                              * ql + 1))
    return out
