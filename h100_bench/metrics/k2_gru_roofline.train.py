"""k2_gru_roofline.train: the least time of the traced steps' GRU layer
sweeps (flops.train_sweeps: every layer of every tier, T = seq_len / frame,
forward and backward; the steps counted by gru_layer's launch counters)
over the device time of the fused GRU kernels in the trace
(kernels/gru_layer.py, csrc/gru_layer.cu)."""

from h100_bench import flops
from h100_bench.trace import short_name

KERNELS = ("gru_fwd_", "gru_bwd_")


def read(ctx, win):
    raw = win.raw
    if win.trace is None or not raw.get("traced_sweeps"):
        return None
    secs, _ = win.trace.kernel_time(lambda n: short_name(n).startswith(KERNELS))
    if secs <= 0:
        return None
    sweeps = flops.train_sweeps(ctx.model, raw["batch"], raw["seq_len"],
                                raw["dtype"])
    steps = raw["traced_sweeps"] / len(sweeps)
    return 100.0 * steps * sum(b for _, b in sweeps) / secs
