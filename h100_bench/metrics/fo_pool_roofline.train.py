"""fo_pool_roofline.train: the least time of the traced steps' fo-pool
sweeps (flops_qrnn.train_pools: every QRNN layer of every tier, T =
seq_len / frame, forward and backward, bytes over 3.35 TB/s; the steps
counted by the fo-pool kernel's launch counters, `traced_pools`) over the
device time of the fo-pool kernels in the trace (kernels/fo_pool.py,
csrc/fo_pool.cu). The bytes are those the function needs (flops_qrnn.
pool_bytes: its inputs and outputs once, one saved cell a block of 8
steps), not the kernel's own, which saves every c_t in float32."""

from h100_bench import flops_qrnn
from h100_bench.trace import short_name

KERNELS = ("fo_pool_fwd", "fo_pool_bwd")


def read(ctx, win):
    raw = win.raw
    if win.trace is None or not raw.get("traced_pools"):
        return None
    secs, _ = win.trace.kernel_time(lambda n: short_name(n).startswith(KERNELS))
    if secs <= 0:
        return None
    pools = flops_qrnn.train_pools(ctx.model, raw["batch"], raw["seq_len"],
                                   raw["dtype"])
    steps = raw["traced_pools"] / len(pools)
    return 100.0 * steps * sum(b for _, b in pools) / secs
