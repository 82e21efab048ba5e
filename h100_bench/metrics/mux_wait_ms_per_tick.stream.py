"""mux_wait_ms_per_tick.stream: the mean `mux.wait` span of serving/mux.py, in
ms (a drained tick's wait for its audio on the host), from the program's
spans (msnv_tpu_torch/utils/profiling.py) recorded in the traced window."""

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    totals = getattr(profiling, "totals", None)   # a port without spans
    if totals is None:
        return None
    spans = totals()
    count, _ = spans.get("mux.wait", (0, 0.0))
    _, secs = spans.get("mux.wait", (0, 0.0))
    return 1e3 * secs / count if count else None
