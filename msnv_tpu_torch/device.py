"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another. Raises when CUDA is asked for (or defaulted to) and is
    absent — nothing falls back to the CPU silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def float32_convolutions():
    """Run float32 convolutions in float32. PyTorch's default
    (`torch.backends.cudnn.allow_tf32` True) sends them to cuDNN in TF32,
    which keeps 10 bits of each operand: on one float32 GAN step at full
    width (the discriminator's 5 x 5 convolutions) that moves the gradients
    by more than the port's float32 tolerance (chip_smoke.py phase 9).
    Float32 matmuls are full float32 by default already. bf16 convolutions
    are not affected."""
    torch.backends.cudnn.allow_tf32 = False
