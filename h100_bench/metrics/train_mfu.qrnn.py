"""train_mfu.qrnn: model FLOPs of the window's train steps with QRNN tiers
(flops_qrnn.train_step: a QRNN layer's frame step is 2 x d_in x 3H, the
pool element-wise and left out) over the window's wall time, as a share of
the card's peak for the products' type (bf16 989 TFLOP/s, float32 165
TFLOP/s, split TF32) (training/step.py)."""

from h100_bench import flops_qrnn, peaks


def read(ctx, win):
    raw = win.raw
    if not raw.get("steps"):
        return None
    per_step = flops_qrnn.train_step(ctx.model, raw["batch"], raw["seq_len"])
    return (100.0 * per_step * raw["steps"] / raw["wall_s"]
            / peaks.peak_flops(raw["dtype"]))
