"""Adversarial (samplernn-gan) train step: two optimizers, a lambda ramp.

Port of the JAX package's training/gan.py (ref doc/Barbany_report.pdf
§3.2.2, run_samplegan.sh --lambda_weight 0 0.01 50000):

- L1 is the vocoder NLL (bits); L2 the discriminator's speaker NLL on the
  conditioner latent;
- the discriminator optimizer minimizes L2 over the discriminator's params;
- the main optimizer minimizes L1 - lambda * L2 over the vocoder's params
  (gradient reversal through the latent: the conditioner learns to strip
  speaker identity);
- lambda ramps linearly from start to target over ramp_steps, then stays;
  with cfg.lambda_adaptive = (target_nll, gain, max_mult) it is scaled by
  exp(gain * (target_nll - L2)) clipped to [1/max_mult, max_mult].

One vocoder forward, one discriminator forward and ONE discriminator
backward per step: autograd.grad of L2 over the discriminator's leaves and
a detached copy of the latent gives both the discriminator's gradients and
g_latent; the vocoder's backward is then fed (dL1 = 1, -lambda * g_latent).
The naive form (grad of L1 - lambda L2 for the vocoder, then grad of L2 for
the discriminator) runs the discriminator forward and its dgrad chain twice
for the same numbers: the chain is linear in its cotangent. Both optimizers
see gradients at the pre-update params. lambda stays a device tensor: the
step makes no host sync.

Three forms share the core, as in training/step.py: tensor arguments
(`make_gan_train_step`), a chunk index into a device-resident corpus
(`make_gan_train_step_indexed`) and a block of chunk indices
(`make_gan_train_block_scan`, whose ramp step is step_idx0 + position).
params, disc_params and both optimizer states are updated IN PLACE.

Over a device mesh (`mesh=` and `specs=`, as in training/step.py) the
builders return the sharded step. The vocoder params follow
`param_sharding` (this rank's storage; full weights gathered once per
step); the discriminator and its optimizer state are replicated. Each
rank runs the step on its lanes; L1 and L2 are reduced over 'data' before
the adaptive multiplier reads L2, and both gradient trees are reduced
(sum / n_data) before their clips and updates: the vocoder's local
gradient dL1_r - lambda dL2_r averages to the global batch's, since both
losses are means over equal shards. The replicas of both trees must be
equal when the first step runs (`broadcast_tree`; Trainer sees to it).

While a torch.profiler records, the step times two sections of its stream
on the device (utils/profiling.py): `train.disc`, the discriminator's
forward and its one backward, and `train.optim`, both optimizers' updates.
"""

from __future__ import annotations

import torch

from msnv_tpu_torch.config import ModelConfig, TrainConfig
from msnv_tpu_torch.models.discriminator import discriminator_nll
from msnv_tpu_torch.models.generate import cast_float_tree
from msnv_tpu_torch.ops.xent import nll_bits_from_logits
from msnv_tpu_torch.parallel.mesh import (data_mean, gather_params,
                                          reduce_gradients, shard_params)
from msnv_tpu_torch.training.step import (_forward, check_mesh_specs,
                                          chunk_slices, freeze_h0_grads,
                                          grad_leaves, grads_like,
                                          state_stop_gradient)
from msnv_tpu_torch.tree import tree_leaves
from msnv_tpu_torch.utils import profiling

METRICS = ("loss", "disc_loss", "lambda")


def _f32(value, device):
    """A float32 0-d tensor filled on `device` (no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=device)


def lambda_ramp(cfg: TrainConfig, step, device=None):
    """start + (target - start) * clip(step / max(ramp_steps, 1), 0, 1), in
    float32 as the JAX package computes it. `step` is a number or a 0-d
    tensor; the result is a 0-d float32 tensor on `device` (step's)."""
    start, target, ramp_steps = cfg.lambda_weight
    if torch.is_tensor(step):
        device = step.device
        step = step.to(torch.float32)
    else:
        step = _f32(float(step), device)
    frac = torch.clamp(step / _f32(max(ramp_steps, 1.0), device), 0.0, 1.0)
    return _f32(start, device) + _f32(target - start, device) * frac


def adaptive_lambda(cfg: TrainConfig, lam, l2):
    """lam * clip(exp(gain * (target_nll - l2)), 1/max_mult, max_mult) with
    cfg.lambda_adaptive = (target_nll, gain, max_mult); lam itself when
    that is None."""
    if cfg.lambda_adaptive is None:
        return lam
    target_nll, gain, max_mult = cfg.lambda_adaptive
    mult = torch.exp(gain * (target_nll - l2))
    return lam * torch.clamp(mult, 1.0 / max_mult, max_mult)


def _disc_loss(disc_params, latent, spk, compute_dtype):
    """L2. The discriminator follows the vocoder's compute type: its convs
    in bf16 under mixed precision, InstanceNorm statistics and the
    classifier in float32 (models/discriminator.py). The cast is inside the
    differentiated function: grads land in float32."""
    if compute_dtype is not None:
        disc_params = cast_float_tree(disc_params, compute_dtype)
        latent = latent.to(compute_dtype)
    return discriminator_nll(disc_params, latent, spk)


def _check_gan(model_cfg):
    if model_cfg.variant != "gan":
        raise ValueError(f"the GAN step needs variant 'gan', got "
                         f"{model_cfg.variant!r}")


def _make_gan_core(model_cfg: ModelConfig, train_cfg: TrainConfig,
                   main_opt, disc_opt, compute_dtype, mesh=None, specs=None):
    """core(params, disc_params, main_opt_state, disc_opt_state, state,
    step_idx, data, reset, target, cond, spk)
      -> (params, disc_params, main_opt_state, disc_opt_state, state,
          {"loss": L1 bits, "disc_loss": L2, "lambda": lam})"""
    _check_gan(model_cfg)

    def core(params, disc_params, main_opt_state, disc_opt_state, state,
             step_idx, data, reset, target, cond, spk):
        lam = lambda_ramp(train_cfg, step_idx, data.device)
        full = params if mesh is None else gather_params(mesh, params, specs)
        leaves = grad_leaves(full)
        d_leaves = grad_leaves(disc_params)
        with torch.enable_grad():
            logits, new_state, latent = _forward(
                leaves, model_cfg, compute_dtype, state, data, reset, cond,
                spk)
            latent = latent.to(torch.float32)
            l1 = nll_bits_from_logits(logits, target)
            lat = latent.detach().requires_grad_(True)
        with profiling.section("train.disc", data.device):
            with torch.enable_grad():
                l2 = _disc_loss(d_leaves, lat, spk, compute_dtype)
            # the one discriminator backward: its weight gradients and
            # g_latent
            *d_grads, g_latent = torch.autograd.grad(
                l2, tree_leaves(d_leaves) + [lat], allow_unused=True)
        l1_all, l2_all = l1.detach(), l2.detach()
        if mesh is not None:
            l1_all, l2_all = data_mean(mesh, [l1_all, l2_all])
        lam = adaptive_lambda(train_cfg, lam, l2_all)
        grads = grads_like(leaves, torch.autograd.grad(
            (l1, latent), tree_leaves(leaves),
            grad_outputs=(torch.ones_like(l1), (-lam) * g_latent),
            allow_unused=True))
        grads = freeze_h0_grads(model_cfg, grads)
        d_grads = grads_like(d_leaves, d_grads)
        if mesh is not None:
            both, = reduce_gradients(
                mesh, {"vocoder": grads, "disc": d_grads}, None)
            grads = shard_params(mesh, both["vocoder"], specs)
            d_grads = both["disc"]
        with profiling.section("train.optim", data.device):
            params, main_opt_state = main_opt.update(grads, main_opt_state,
                                                     params)
            disc_params, disc_opt_state = disc_opt.update(
                d_grads, disc_opt_state, disc_params)
        metrics = {"loss": l1_all, "disc_loss": l2_all, "lambda": lam}
        return (params, disc_params, main_opt_state, disc_opt_state,
                state_stop_gradient(new_state), metrics)

    return core


def naive_gan_grads(model_cfg: ModelConfig, train_cfg: TrainConfig, params,
                    disc_params, state, step_idx, data, reset, target, cond,
                    spk, compute_dtype=None):
    """The two-backward formulation that the step's shared discriminator
    backward replaces, kept as its yardstick: the gradients of
    L1 - lam * L2 over the vocoder's params (through the latent), then of
    L2 over the discriminator's with the latent detached.
    -> (vocoder grads with h0 frozen as the step does, discriminator grads,
    lam); params are not changed."""
    _check_gan(model_cfg)
    lam = lambda_ramp(train_cfg, step_idx, data.device)
    leaves = grad_leaves(params)
    d_leaves = grad_leaves(disc_params)
    with torch.enable_grad():
        logits, _, latent = _forward(leaves, model_cfg, compute_dtype, state,
                                     data, reset, cond, spk)
        latent = latent.to(torch.float32)
        l1 = nll_bits_from_logits(logits, target)
        l2_through = _disc_loss(disc_params, latent, spk, compute_dtype)
        lam = adaptive_lambda(train_cfg, lam, l2_through.detach())
        grads = grads_like(leaves, torch.autograd.grad(
            l1 - lam * l2_through, tree_leaves(leaves), allow_unused=True))
        l2 = _disc_loss(d_leaves, latent.detach(), spk, compute_dtype)
        d_grads = grads_like(d_leaves, torch.autograd.grad(
            l2, tree_leaves(d_leaves), allow_unused=True))
    return freeze_h0_grads(model_cfg, grads), d_grads, lam


def make_gan_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                        main_opt, disc_opt, mesh=None, compute_dtype=None,
                        specs=None):
    """The two-optimizer step:

    step(params, disc_params, main_opt_state, disc_opt_state, state,
         step_idx, data, reset, target, cond, spk)
      -> (params, disc_params, main_opt_state, disc_opt_state, state,
          {"loss": L1 bits, "disc_loss": L2, "lambda": lam})

    compute_dtype=torch.bfloat16 is mixed precision, for the vocoder and
    the discriminator alike; the metrics are 0-d float32 device tensors.
    With `mesh` (and `specs`), the sharded step (module docstring).
    """
    _check_gan(model_cfg)
    check_mesh_specs(mesh, specs)
    return _make_gan_core(model_cfg, train_cfg, main_opt, disc_opt,
                          compute_dtype, mesh, specs)


def _gan_indexed(model_cfg, train_cfg, main_opt, disc_opt, geo,
                 compute_dtype, mesh, specs):
    core = _make_gan_core(model_cfg, train_cfg, main_opt, disc_opt,
                          compute_dtype, mesh, specs)

    def step(params, disc_params, main_opt_state, disc_opt_state, state,
             step_idx, corpus, k):
        data, reset, target, cond, spk = chunk_slices(corpus, int(k), *geo)
        return core(params, disc_params, main_opt_state, disc_opt_state,
                    state, step_idx, data, reset, target, cond, spk)

    return step


def make_gan_train_step_indexed(model_cfg: ModelConfig,
                                train_cfg: TrainConfig, main_opt, disc_opt,
                                seq_len: int, overlap_len: int,
                                cond_in_seq: int, compute_dtype=None,
                                mesh=None, specs=None):
    """The GAN step over a device-resident corpus:

    step(params, disc_params, main_opt_state, disc_opt_state, state,
         step_idx, corpus, k) -> (..., metrics)

    The same numbers as make_gan_train_step on the host-sliced tensors.
    With `mesh` (and `specs`), the sharded step."""
    _check_gan(model_cfg)
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    return _gan_indexed(model_cfg, train_cfg, main_opt, disc_opt, geo,
                        compute_dtype, mesh, specs)


def make_gan_train_block_scan(model_cfg: ModelConfig,
                              train_cfg: TrainConfig, main_opt, disc_opt,
                              seq_len: int, overlap_len: int,
                              cond_in_seq: int, mesh=None,
                              compute_dtype=None, specs=None):
    """Multi-step GAN training over a device-resident corpus:

    run_block(params, disc_params, main_opt_state, disc_opt_state, state,
              step_idx0, corpus, ks)
      -> (params, disc_params, main_opt_state, disc_opt_state, state,
          {"loss": (len(ks),), "disc_loss": (len(ks),), "lambda": ...})

    The indexed step for each chunk index of `ks` in order, the ramp's
    step at step_idx0 + position, the metrics stacked on the device (one
    fetch per block for the caller). With `mesh` (and `specs`), the
    sharded form."""
    _check_gan(model_cfg)
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    step = _gan_indexed(model_cfg, train_cfg, main_opt, disc_opt, geo,
                        compute_dtype, mesh, specs)

    def run_block(params, disc_params, main_opt_state, disc_opt_state,
                  state, step_idx0, corpus, ks):
        out = {name: [] for name in METRICS}
        for i, k in enumerate(ks):
            (params, disc_params, main_opt_state, disc_opt_state, state,
             metrics) = step(params, disc_params, main_opt_state,
                             disc_opt_state, state, step_idx0 + i, corpus, k)
            for name in METRICS:
                out[name].append(metrics[name])
        return (params, disc_params, main_opt_state, disc_opt_state, state,
                {name: torch.stack(v) for name, v in out.items()})

    return run_block
