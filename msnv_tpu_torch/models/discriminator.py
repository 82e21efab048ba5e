"""Speaker discriminator of the samplernn-gan variant.

Port of the JAX package's models/discriminator.py. From the thesis (ref
doc/Barbany_report.pdf §3.2.2 + fig 3.5): the conditioner latent map
(B, T, ind_cond_dim), taken as a one-channel (T, ind_cond_dim) image,
passes through 4 blocks of

  [ReflectionPad 2 -> Conv2d 5x5 (1->C, then C->C) -> LeakyReLU 0.2
   -> ReflectionPad 2 -> Conv2d 5x5 (no bias) -> InstanceNorm2d]

with an additive skip where the channel counts match (so not in block 1),
then a classifier LeakyReLU -> mean-pool -> dense -> log-softmax, in
float32. InstanceNorm is non-affine, its statistics always float32 (the
population variance, as jnp.var takes it).

Layout: the JAX tree's, so checkpoints cross leaf for leaf. A conv weight
is HWIO (5, 5, in, out) and is permuted to torch's OIHW at the call; JAX's
NHWC image latent[..., None] is torch's NCHW latent[:, None]. Both are
cross-correlations. On a CUDA tensor the convolutions run in cuDNN in
channels_last memory order (the same results; the JAX package runs them as
plain lax.conv, no Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from msnv_tpu_torch.device import resolve_device
from msnv_tpu_torch.ops.linear import dense_apply, dense_init, kaiming_uniform

N_BLOCKS = 4
CHANNELS = 512
KERNEL = 5
PAD = 2
LEAK = 0.2


def _conv_init(generator, in_ch, out_ch, bias=True, device="cpu"):
    p = {"w": kaiming_uniform(generator, (KERNEL, KERNEL, in_ch, out_ch),
                              fan_in=KERNEL * KERNEL * in_ch, device=device)}
    if bias:
        p["b"] = torch.zeros((out_ch,), device=device)
    return p


def discriminator_init(generator, spk_dim: int, channels: int = CHANNELS, *,
                       device=None):
    """Params {"blocks": [{"conv1": {w, b}, "conv2": {w}}] * 4,
    "classifier": {w (spk_dim, channels), b}} on `device` (`cuda` unless
    the caller passes another; see `resolve_device`)."""
    device = resolve_device(device)
    blocks = []
    in_ch = 1
    for _ in range(N_BLOCKS):
        blocks.append({
            "conv1": _conv_init(generator, in_ch, channels, device=device),
            # no bias before InstanceNorm, which subtracts the map's mean
            "conv2": _conv_init(generator, channels, channels, bias=False,
                                device=device),
        })
        in_ch = channels
    return {"blocks": blocks,
            "classifier": dense_init(generator, channels, spk_dim,
                                     device=device)}


def _reflect_pad(x):
    """(B, C, H, W) reflect-padded by 2 on H and W (needs H, W > 2)."""
    return F.pad(x, (PAD, PAD, PAD, PAD), mode="reflect")


def _conv(p, x):
    """Valid 5x5 cross-correlation of an NCHW map with an HWIO weight."""
    w = p["w"].permute(3, 2, 0, 1)                       # HWIO -> OIHW
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
        w = w.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, w, p.get("b"))


def _instance_norm(x, eps: float = 1e-5):
    """Non-affine InstanceNorm2d over each (sample, channel) map, its
    statistics in float32 whatever x's type."""
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=(2, 3), keepdim=True)
    c = x32 - mean
    var = torch.mean(c * c, dim=(2, 3), keepdim=True)
    return (c * torch.rsqrt(var + eps)).to(x.dtype)


def discriminator_apply(params, latent):
    """latent (B, T, ind_cond_dim) -> per-speaker log-probs (B, spk_dim),
    float32."""
    x = latent[:, None]                                  # (B, 1, T, C_lat)
    for block in params["blocks"]:
        y = _conv(block["conv1"], _reflect_pad(x))
        y = F.leaky_relu(y, LEAK)
        y = _conv(block["conv2"], _reflect_pad(y))
        y = _instance_norm(y)
        x = y + x if x.shape[1] == y.shape[1] else y
    pooled = torch.mean(F.leaky_relu(x, LEAK).to(torch.float32), dim=(2, 3))
    cls = {k: v.to(torch.float32) for k, v in params["classifier"].items()}
    return torch.log_softmax(dense_apply(cls, pooled), dim=-1)


def discriminator_nll(params, latent, spk):
    """Speaker-classification NLL (the L2 term), in nats."""
    log_probs = discriminator_apply(params, latent)
    return -torch.mean(torch.gather(log_probs, -1, spk[:, None].long()))
