"""fo_pool_ms_per_step.train: the device time of the fo-pool kernels
(kernels/fo_pool.py, csrc/fo_pool.cu: `fo_pool_fwd`, `fo_pool_bwd`) in the
traced window over its train steps (`traced_steps`), in ms."""

from h100_bench.trace import short_name

KERNELS = ("fo_pool_fwd", "fo_pool_bwd")


def read(ctx, win):
    steps = win.raw.get("traced_steps")
    if win.trace is None or not steps:
        return None
    secs, _ = win.trace.kernel_time(lambda n: short_name(n).startswith(KERNELS))
    return 1e3 * secs / steps if secs > 0 else None
