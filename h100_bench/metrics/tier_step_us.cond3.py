"""tier_step_us.cond3: the device time of the traced ticks' kernels other
than the sample window's (the frame tiers' products, gates and upsampling,
the conditioner, the attach splices) over the frame-tier steps those ticks
issued, in us. Copies and sets are left out.

A captured tick hides its steps from the host, but their count follows from
the configuration: each of a push's K frames steps tier t once every
ns_frame_samples[t] of its lookback samples, all lanes at once, so a tick
issues K x the sum of lookback / ns_frame_samples[t] steps (4 x (1 + 4 +
20) at frame sizes (4, 5, 4) and K 4), times the traced ticks
(`traced_ticks`, the change in StreamMultiplexer.ticks, serving/mux.py)."""

from h100_bench.trace import short_name

WINDOW = ("window_resident", "window_grid", "sample_window_kernel")
NOT_KERNELS = ("Memcpy", "Memset")


def _tier_kernel(name):
    short = short_name(name)
    return not short.startswith(WINDOW + NOT_KERNELS)


def steps_per_tick(frame_sizes, frames_per_push):
    ns, acc = [], 1
    for fs in frame_sizes:
        acc *= fs
        ns.append(acc)
    return frames_per_push * sum(ns[-1] // n for n in ns)


def read(ctx, win):
    ticks = win.raw.get("traced_ticks")
    if win.trace is None or not ticks:
        return None
    secs, _ = win.trace.kernel_time(_tier_kernel)
    if secs <= 0:
        return None
    steps = ticks * steps_per_tick(ctx.model["frame_sizes"],
                                   ctx.traffic["frames_per_push"])
    return 1e6 * secs / steps
