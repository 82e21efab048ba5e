"""Live streams through the multiplexer, as drivers/stream.py drives them
(the same traffic, metrics and check), with one change to the traced
window: the pump is held between ticks (the multiplexer's carry lock) while
the traced ticks are counted and the profiler stops. A profiler stopped
while the pump replays a graph of some 5,000 nodes a tick every 11 ms did
not return in ten minutes on an H100, where the same profiler stopped after
20 such ticks in 1.5 s. The traced window ends before the hold begins, so
the hold changes none of its readings; the streams resume after it.
"""

from __future__ import annotations

import time

import numpy as np

from h100_bench import harness, stats, trace
from h100_bench.drivers import stream


class Driver(stream.Driver):
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
            with self.mux._carry_lock:          # the pump held: see above
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
