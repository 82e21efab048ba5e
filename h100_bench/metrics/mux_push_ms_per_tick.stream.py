"""mux_push_ms_per_tick.stream: the mean `mux.push` span of serving/mux.py, in
ms (a tick's host-to-device copies, its masked push and its audio fetch's
start), from the program's spans (msnv_tpu_torch/utils/profiling.py)
recorded in the traced window."""

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    totals = getattr(profiling, "totals", None)   # a port without spans
    if totals is None:
        return None
    spans = totals()
    count, _ = spans.get("mux.push", (0, 0.0))
    _, secs = spans.get("mux.push", (0, 0.0))
    return 1e3 * secs / count if count else None
