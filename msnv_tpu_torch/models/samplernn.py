"""SampleRNN core: tiered frame-level GRUs + sample-level MLP, in PyTorch.

Port of the JAX package's models/samplernn.py. Parameters are a plain
nested dict with the JAX package's tree and layouts, so a checkpoint
written by the JAX trainer loads leaf for leaf (msnv_tpu_torch/interop.py):

  {"tiers": [tier0 (bottom) .. tierK (top)], "mlp": {...}}
  tier: {"h0" (n_rnn, dim), "input_expand" {w (dim, nfs), b},
         "gru" [{w_ih (3H, in), w_hh (3H, H), b_ih, b_hh}, ...]
                (with cfg.qrnn: [{w (3H, in), b}, ...], ops/qrnn.py),
         "upsample" {w (dim, fs, dim), bias (fs, dim)}}
  top tier also: {"conditioner" {["stack"], "expand"}, "spk_embedding"
                  (spk, spk), "spk_expand"}
  mlp: {"embedding" (q, q), "conv_in" (fs0, q, dim), "hidden", "out"}

`predictor_apply` is differentiable end to end (the train step,
training/step.py, takes gradients through it): the sample MLP's input stage
goes through ops/embed_conv.py, whose backward is reassociated through the
fused table unless cfg.mlp_grad_impl is "direct", and with
cfg.gru_impl="pallas" the tier GRUs' sweeps run in the fused kernel, forward
and backward (kernels/gru_layer.py).

Deliberate reference-quirk parity, as in the JAX package: tier inputs are
`2 * dequantize(x)`, only the top tier is conditioned, the speaker
embedding is (spk_dim x spk_dim), the MLP input conv has no bias, and the
loss is NLL in bits.
"""

from __future__ import annotations

import math
from typing import List

import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.device import resolve_device
from msnv_tpu_torch.models.conditioner import (conditioner_apply,
                                               conditioner_init)
from msnv_tpu_torch.ops.embed_conv import embed_conv, embed_conv_direct
from msnv_tpu_torch.ops.gru import gru_apply, gru_cell, gru_init
from msnv_tpu_torch.ops.linear import (dense_apply, dense_init,
                                       kaiming_uniform, lecun_uniform, normal)
from msnv_tpu_torch.ops.qrnn import qrnn_apply, qrnn_cell, qrnn_init
from msnv_tpu_torch.ops.quantize import linear_dequantize, udequantize
from msnv_tpu_torch.ops.upsample import upsample_apply, upsample_init


def dequantize(cfg: ModelConfig, x):
    """Selected dequantizer (ref model.py:29-32)."""
    if cfg.ulaw:
        return udequantize(x, cfg.q_levels)
    return linear_dequantize(x, cfg.q_levels)


# --------------------------------------------------------------------------
# Recurrent-cell dispatch: GRU (default) or fo-pool QRNN (cfg.qrnn). Both
# share the (n_layers, B, H) state layout, so everything downstream (TBPTT
# state, learned-h0 reset, checkpoints) is cell-agnostic. A QRNN ignores
# cfg.gru_impl: its loop is elementwise and has no kernel.
# --------------------------------------------------------------------------

def rnn_init(cfg: ModelConfig, generator, n_layers, in_dim, hidden, *,
             device="cpu"):
    init = qrnn_init if cfg.qrnn else gru_init
    return init(generator, n_layers, in_dim, hidden, device=device)


def rnn_apply(cfg: ModelConfig, params, x, h0):
    if cfg.qrnn:
        return qrnn_apply(params, x, h0)
    return gru_apply(params, x, h0, impl=cfg.gru_impl)


def rnn_cell(cfg: ModelConfig, params, x, h):
    return (qrnn_cell if cfg.qrnn else gru_cell)(params, x, h)


# --------------------------------------------------------------------------
# Parameter initialization
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator=None, *, device=None):
    """Build the parameter tree (layout in the module docstring).

    generator: a CPU torch.Generator (default: seeded with 0); draws are
    made on the CPU and moved to `device`, so a seed gives the same weights
    everywhere. device="meta" builds a shape/dtype template without
    drawing anything.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kw = {"device": device}
    n_tiers = cfg.n_tiers
    tiers = []
    for t, (fs, nfs) in enumerate(zip(cfg.frame_sizes, cfg.ns_frame_samples)):
        tier = {
            "h0": torch.zeros((cfg.n_rnn, cfg.dim), **kw),
            "input_expand": dense_init(generator, nfs, cfg.dim,
                                       init=kaiming_uniform,
                                       weight_norm=cfg.weight_norm, **kw),
            "gru": rnn_init(cfg, generator, cfg.n_rnn, cfg.dim, cfg.dim,
                            **kw),
            "upsample": upsample_init(generator, cfg.dim, fs, cfg.dim,
                                      weight_norm=cfg.weight_norm, **kw),
        }
        if t == n_tiers - 1:
            tier["conditioner"] = conditioner_init(generator, cfg, **kw)
            tier["spk_embedding"] = normal(generator,
                                           (cfg.spk_dim, cfg.spk_dim), **kw)
            tier["spk_expand"] = dense_init(generator, cfg.spk_dim, cfg.dim,
                                            init=kaiming_uniform,
                                            weight_norm=cfg.weight_norm, **kw)
        tiers.append(tier)

    fs0 = cfg.frame_sizes[0]
    q = cfg.q_levels
    mlp = {
        "embedding": normal(generator, (q, q), **kw),
        "conv_in": kaiming_uniform(generator, (fs0, q, cfg.dim),
                                   fan_in=q * fs0, **kw),
        "hidden": dense_init(generator, cfg.dim, cfg.dim,
                             init=kaiming_uniform,
                             weight_norm=cfg.weight_norm, **kw),
        "out": dense_init(generator, cfg.dim, q, init=lecun_uniform,
                          weight_norm=cfg.weight_norm, **kw),
    }
    if cfg.weight_norm:
        w = mlp["conv_in"]
        mlp["conv_in_g"] = torch.sqrt(torch.sum(w * w, dim=(0, 1)))
    return {"tiers": tiers, "mlp": mlp}


def init_tier_state(cfg: ModelConfig, batch_size: int, *, device=None):
    """Zeroed TBPTT hidden state: one (n_rnn, B, dim) tensor per tier."""
    device = resolve_device(device)
    return [torch.zeros((cfg.n_rnn, batch_size, cfg.dim), device=device)
            for _ in cfg.frame_sizes]


# --------------------------------------------------------------------------
# Forward pieces
# --------------------------------------------------------------------------

def _tier_forward(tier_params, cfg: ModelConfig, prev_frames, upper_cond,
                  cond, spk, hidden):
    """One frame-level tier (ref model.py:180-263).

    prev_frames (B, T, nfs); upper_cond (B, T, dim) or None for the top
    tier, which takes cond (B, T, C) and spk (B,) instead; hidden
    (n_rnn, B, dim). Returns (upsampled (B, T*fs, dim), new_hidden, latent).
    """
    x = dense_apply(tier_params["input_expand"], prev_frames)
    latent = None
    if upper_cond is not None:
        x = x + upper_cond
    else:
        c, latent = conditioner_apply(tier_params["conditioner"], cfg, cond)
        spk_vec = dense_apply(tier_params["spk_expand"],
                              tier_params["spk_embedding"][spk])
        x = x + c + spk_vec[:, None, :]
    y, new_hidden = rnn_apply(cfg, tier_params["gru"], x, hidden)
    return upsample_apply(tier_params["upsample"], y), new_hidden, latent


def mlp_conv_weight(mlp_params):
    """Effective (fs0, q, dim) input-conv weight (applies weight norm)."""
    w = mlp_params["conv_in"]
    if "conv_in_g" in mlp_params:
        norm = torch.sqrt(torch.sum(w * w, dim=(0, 1), keepdim=True))
        w = mlp_params["conv_in_g"] * w / norm
    return w


def fused_embed_conv(mlp_params):
    """(fs0, q, dim) table T with T[p, s] = embedding[s] @ conv_w[p].

    The MLP input conv over embedded samples is linear in the one-hot
    sample ids, so it is fs0 row gathers from this table. Weight norm is
    folded in."""
    w = mlp_conv_weight(mlp_params)                          # (fs0, q, dim)
    return torch.einsum("se,peo->pso", mlp_params["embedding"], w)


def sample_mlp_logits(mlp_params, cfg: ModelConfig, samples, upper_cond):
    """Sample-level MLP over a whole chunk, pre-softmax (ref model.py:266-325).

    samples (B, L + fs0 - 1) int; upper_cond (B, L, dim). Returns f32
    logits (B, L, q). The embed + valid conv is `embed_conv` (a gather of
    fused-table rows forward, the reassociated gradient backward) or, with
    cfg.mlp_grad_impl="direct", the plain embed-then-conv.
    """
    w = mlp_conv_weight(mlp_params)                          # (fs0, q, dim)
    impl = embed_conv if cfg.mlp_grad_impl == "fused" else embed_conv_direct
    x = torch.relu(impl(mlp_params["embedding"], w, samples) + upper_cond)
    x = torch.relu(dense_apply(mlp_params["hidden"], x))
    return dense_apply(mlp_params["out"], x).to(torch.float32)


def sample_mlp_forward(mlp_params, cfg: ModelConfig, samples, upper_cond):
    """Sample-level MLP log-probs (ref model.py:325)."""
    return torch.log_softmax(
        sample_mlp_logits(mlp_params, cfg, samples, upper_cond), dim=-1)


# --------------------------------------------------------------------------
# Predictor: TBPTT chunk forward
# --------------------------------------------------------------------------

def predictor_apply(params, cfg: ModelConfig, input_sequences, reset, cond,
                    spk, state, output="log_probs"):
    """Forward one TBPTT chunk (ref model.py:352-436 Predictor.forward).

    input_sequences (B, seq_len + lookback - 1) int; reset: bool or 0-d
    bool tensor (substitute the learned h0 for the carried state); cond
    (B, seq_len // lookback, C); spk (B,) int; state: list of
    (n_rnn, B, dim). Returns (log_probs or logits (B, seq_len, q),
    new_state, latent_or_None).
    """
    batch = input_sequences.shape[0]
    lookback = cfg.lookback
    total = input_sequences.shape[1]
    seq_len = total - lookback + 1
    reset = torch.as_tensor(reset, device=input_sequences.device)

    new_state: List = [None] * cfg.n_tiers
    upper_cond = None
    latent = None
    for t in range(cfg.n_tiers - 1, -1, -1):       # top tier first
        tier = params["tiers"][t]
        nfs = cfg.ns_frame_samples[t]
        wdtype = tier["input_expand"]["w"].dtype
        sl = input_sequences[:, lookback - nfs:total - nfs + 1]
        prev = (2.0 * dequantize(cfg, sl)).to(wdtype)
        prev = prev.reshape(batch, seq_len // nfs, nfs)
        h0 = tier["h0"][:, None, :].expand(cfg.n_rnn, batch, cfg.dim)
        hidden = torch.where(reset, h0, state[t].to(wdtype))
        is_top = t == cfg.n_tiers - 1
        out, new_hidden, lat = _tier_forward(
            tier, cfg, prev, upper_cond,
            cond.to(wdtype) if is_top else None,
            spk if is_top else None,
            hidden)
        if is_top:
            latent = lat
        new_state[t] = new_hidden
        upper_cond = out

    fs0 = cfg.frame_sizes[0]
    mlp_samples = input_sequences[:, lookback - fs0:]
    mlp_fn = (sample_mlp_logits if output == "logits"
              else sample_mlp_forward)
    return mlp_fn(params["mlp"], cfg, mlp_samples, upper_cond), new_state, \
        latent


def sequence_nll_loss_bits(log_probs, targets):
    """Mean NLL over all positions, in bits (ref nn.py:66-70)."""
    nll = -torch.gather(log_probs, -1, targets[..., None].long())
    return torch.mean(nll) * (1.0 / math.log(2.0))
