"""mux_inflight_p95_ms.stream: the 95th percentile of the `mux.inflight`
intervals of serving/mux.py, in ms (a tick's push end to its delivery's
end), from the program's spans (msnv_tpu_torch/utils/profiling.py) recorded
in the traced window."""

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    percentile = getattr(profiling, "percentile", None)   # no spans
    if percentile is None:
        return None
    secs = percentile("mux.inflight", 95)
    return None if secs is None else 1e3 * secs
