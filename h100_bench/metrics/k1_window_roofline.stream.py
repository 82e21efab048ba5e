"""k1_window_roofline: the least time of the traced window's sample-window
launches (flops.window_bound_s at the launch's batch, summed over the
launches `sample_window.launches` counted) over the device time of the
sample-window kernels in the trace (kernels/sample_window.py,
csrc/sample_window.cu)."""

from h100_bench import flops
from h100_bench.trace import short_name

KERNELS = ("window_resident", "window_grid", "sample_window_kernel")


def read(ctx, win):
    if win.trace is None or not win.raw.get("traced_launches"):
        return None
    secs, _ = win.trace.kernel_time(lambda n: short_name(n).startswith(KERNELS))
    if secs <= 0:
        return None
    m = ctx.model
    bound = win.raw["traced_launches"] * flops.window_bound_s(
        win.raw["window_batch"], m["frame_sizes"][0], m["q_levels"],
        m["dim"], win.raw["window_dtype"])
    return 100.0 * bound / secs
