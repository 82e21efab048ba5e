"""mux_replay_share.stream: the share of the traced ticks of serving/mux.py
that ran as a CUDA graph replay, in %: the `mux.push` spans (ticks) that
enclose a `mux.replay` span, over every `mux.push` span, from the
program's spans (msnv_tpu_torch/utils/profiling.py) recorded in the traced
window. A replay whose push opened before the profiler started, or closed
after it stopped, has no recorded push and is not counted. Nothing where
no tick replayed: the CPU, a mesh, a port without the graph."""

import bisect

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    records = getattr(profiling, "records", None)   # a port without spans
    if records is None:
        return None
    pushes = records("mux.push")
    starts = sorted(r.start_ns for r in records("mux.replay"))
    if not pushes or not starts:
        return None
    replayed = 0
    for push in pushes:
        i = bisect.bisect_left(starts, push.start_ns)
        replayed += i < len(starts) and starts[i] <= push.end_ns
    return 100.0 * replayed / len(pushes)
