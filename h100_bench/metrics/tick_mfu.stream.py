"""tick_mfu.stream: model FLOPs of the audio the multiplexer's ticks served
to active lanes in the window over the window's wall time, as a share of
the card's bf16 peak (serving/mux.py)."""

from h100_bench import flops, peaks


def read(ctx, win):
    raw = win.raw
    if not raw.get("samples_served"):
        return None
    done = raw["samples_served"] * flops.forward_per_sample(ctx.model)
    return 100.0 * done / raw["window_s"] / peaks.BF16_FLOPS
