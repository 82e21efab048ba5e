"""gen_mfu: model FLOPs of the audio the window generated over its wall
time, as a share of the card's bf16 peak (generation, models/generate.py)."""

from h100_bench import flops, peaks


def read(ctx, win):
    raw = win.raw
    if not raw.get("samples"):
        return None
    done = raw["samples"] * flops.forward_per_sample(ctx.model)
    return 100.0 * done / raw["wall_s"] / peaks.BF16_FLOPS
