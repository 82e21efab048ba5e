"""train_mfu: model FLOPs of the window's train steps over its wall time, as
a share of the card's peak for the products' type (bf16 989 TFLOP/s,
float32 165 TFLOP/s, split TF32) (training/step.py, training/gan.py)."""

from h100_bench import flops, peaks


def read(ctx, win):
    raw = win.raw
    if not raw.get("steps"):
        return None
    disc = ctx.train["disc_channels"] if raw["gan"] else None
    per_step = flops.train_step(ctx.model, raw["batch"], raw["seq_len"],
                                disc)
    return (100.0 * per_step * raw["steps"] / raw["wall_s"]
            / peaks.peak_flops(raw["dtype"]))
