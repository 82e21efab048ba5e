"""Learned upsampling: ConvTranspose1d(k=stride=r) + per-position bias.

Port of the JAX package's ops/upsample.py (ref nn.py:7-43). With
kernel == stride the transposed conv has no overlap, so it is one matmul
that expands each frame vector into `r` output vectors.

Layout is the JAX package's: weight (in_dim, r, out_dim), bias (r, out_dim),
weight-norm "g" (in_dim,). Weight norm applies only when the config asks for
it (the reference always wraps this conv; see the JAX module's note).
"""

from __future__ import annotations

import math

import torch

from msnv_tpu_torch.ops.linear import _uniform


def upsample_init(generator, in_dim: int, ratio: int, out_dim: int,
                  weight_norm: bool = False, *, device="cpu"):
    w = _uniform((in_dim, ratio, out_dim), math.sqrt(6.0 / in_dim),
                 generator, device)
    p = {"w": w, "bias": torch.zeros((ratio, out_dim), device=device)}
    if weight_norm:
        p["g"] = torch.sqrt(torch.sum(w * w, dim=(1, 2)))
    return p


def _weight(p):
    w = p["w"]
    if "g" in p:
        norm = torch.sqrt(torch.sum(w * w, dim=(1, 2), keepdim=True))
        w = p["g"][:, None, None] * w / norm
    return w


def upsample_apply(p, x):
    """x: (B, T, in_dim) -> (B, T*r, out_dim)."""
    w = _weight(p)
    b, t, d = x.shape
    r, o = w.shape[1], w.shape[2]
    y = torch.matmul(x, w.reshape(d, r * o)).reshape(b, t, r, o)
    y = y + p["bias"]
    return y.reshape(b, t * r, o)


def upsample_step(p, x):
    """Single-frame upsample for generation. x: (B, in_dim) -> (B, r, out)."""
    w = _weight(p)
    d, r, o = w.shape
    y = torch.matmul(x, w.reshape(d, r * o)).reshape(x.shape[0], r, o)
    return y + p["bias"]
