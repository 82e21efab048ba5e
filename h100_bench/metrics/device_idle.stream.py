"""device_idle: the share of the traced window in which no operation ran
on the device (torch.profiler's kernels, copies and sets)."""


def read(ctx, win):
    if win.trace is None or win.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)
