"""mux_starved_share.stream: the share of the traced ticks of serving/mux.py
pushed when the card had already finished every earlier tick (the card
waited on the host), in %: the `mux.push` spans that enclose a
`mux.starved` span, over every `mux.push` span, from the program's spans
(msnv_tpu_torch/utils/profiling.py) recorded in the traced window. A
starved tick whose push opened before the profiler started, or closed
after it stopped, has no recorded push and is not counted. Nothing where
no push was recorded, or where the pump counts no starved ticks (a port
without `StreamMultiplexer.starved`)."""

import bisect

from msnv_tpu_torch.serving import mux
from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    records = getattr(profiling, "records", None)   # a port without spans
    if records is None or not hasattr(mux.StreamMultiplexer, "starved"):
        return None
    pushes = records("mux.push")
    if not pushes:
        return None
    starts = sorted(r.start_ns for r in records("mux.starved"))
    starved = 0
    for push in pushes:
        i = bisect.bisect_left(starts, push.start_ns)
        starved += i < len(starts) and starts[i] <= push.end_ns
    return 100.0 * starved / len(pushes)
