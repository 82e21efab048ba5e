"""Conditioner heads: identity / bottleneck / GAN ConditionerCNN.

Port of the JAX package's models/conditioner.py. The reference's two
voice-conversion variants replace the top tier's single `cond_expand`
projection with a stack (ref doc/Barbany_report.pdf sections 3.2.1-3.2.2;
run_sampleneck.sh / run_samplegan.sh):

- "identity":   cond (B, T, C) -> dense C -> dim           (ref model.py:92-100)
- "bottleneck": narrowing stack C -> 40 -> 30 -> 20 -> ind_cond_dim -> dim,
                a low-dimensional speaker-independent code (thesis fig 3.4)
- "gan":        ConditionerCNN C -> C -> C -> ind_cond_dim, whose output
                (the latent) feeds the vocoder after expansion to dim and is
                classified by the speaker discriminator (thesis fig 3.5)

Every layer is dense (a Conv1d k=1) applied per frame, with ReLU between
the stack's layers and none after its last; the expansion is linear. Weight
norm follows cfg.weight_norm.
"""

from __future__ import annotations

import torch

from msnv_tpu_torch.ops.linear import dense_apply, dense_init, kaiming_uniform


def _stack_dims(cfg):
    c = cfg.effective_cond_dim
    if cfg.variant == "bottleneck":
        return [c, 40, 30, 20, cfg.ind_cond_dim]
    if cfg.variant == "gan":
        return [c, c, c, cfg.ind_cond_dim]
    raise ValueError(f"unknown variant {cfg.variant!r}")


def conditioner_init(generator, cfg, *, device="cpu"):
    """Params for the conditioner head given a ModelConfig."""
    kw = {"init": kaiming_uniform, "weight_norm": cfg.weight_norm,
          "device": device}
    if cfg.variant == "identity":
        return {"expand": dense_init(generator, cfg.effective_cond_dim,
                                     cfg.dim, **kw)}
    dims = _stack_dims(cfg)
    stack = [dense_init(generator, dims[i], dims[i + 1], **kw)
             for i in range(len(dims) - 1)]
    return {"stack": stack,
            "expand": dense_init(generator, cfg.ind_cond_dim, cfg.dim, **kw)}


def conditioner_apply(params, cfg, cond):
    """cond (B, T, C) -> (expanded (B, T, dim), latent (B, T, ind_cond_dim)
    or None for the identity head). The latent is the speaker-independent
    code the GAN discriminator classifies."""
    if cfg.variant == "identity":
        return dense_apply(params["expand"], cond), None
    x = cond
    stack = params["stack"]
    for i, layer in enumerate(stack):
        x = dense_apply(layer, x)
        if i < len(stack) - 1:
            x = torch.relu(x)
    return dense_apply(params["expand"], x), x
