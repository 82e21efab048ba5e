"""disc_ms_per_step.train: the `train.disc` sections of training/gan.py (the
discriminator's forward and backward, device time) over the steps recorded
(the count of `train.optim` sections), in ms, from the program's spans
(msnv_tpu_torch/utils/profiling.py) recorded in the traced window."""

from msnv_tpu_torch.utils import profiling


def read(ctx, win):
    totals = getattr(profiling, "totals", None)   # a port without spans
    if totals is None:
        return None
    spans = totals()
    count, _ = spans.get("train.optim", (0, 0.0))
    _, secs = spans.get("train.disc", (0, 0.0))
    return 1e3 * secs / count if count else None
