"""mux_queue_p95_ms.stream: the 95th percentile of the `mux.queue` intervals
of serving/mux.py, in ms (a stream's acquire to the push that first carries
its block), from the program's spans (msnv_tpu_torch/utils/profiling.py)
recorded in the traced window."""

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    percentile = getattr(profiling, "percentile", None)   # no spans
    if percentile is None:
        return None
    secs = percentile("mux.queue", 95)
    return None if secs is None else 1e3 * secs
