"""Conditioner heads. Port of the JAX package's models/conditioner.py.

Only the "identity" head (a dense cond_dim -> dim projection, ref
model.py:92-100) is ported; the "bottleneck" and "gan" stacks are queued.
"""

from __future__ import annotations

from msnv_tpu_torch.ops.linear import dense_apply, dense_init, kaiming_uniform


def _check_variant(cfg):
    if cfg.variant != "identity":
        raise NotImplementedError(
            f"conditioner variant {cfg.variant!r} is not ported yet "
            f"(only 'identity')")


def conditioner_init(generator, cfg, *, device="cpu"):
    """Params for the conditioner head given a ModelConfig."""
    _check_variant(cfg)
    return {"expand": dense_init(generator, cfg.effective_cond_dim, cfg.dim,
                                 init=kaiming_uniform,
                                 weight_norm=cfg.weight_norm,
                                 device=device)}


def conditioner_apply(params, cfg, cond):
    """cond (B, T, C) -> (expanded (B, T, dim), latent None)."""
    _check_variant(cfg)
    return dense_apply(params["expand"], cond), None
