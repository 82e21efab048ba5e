"""TBPTT train / eval steps.

Port of the JAX package's training/step.py: forward -> NLL-bits loss ->
gradients -> element-wise clip -> Adam -> new params, with the TBPTT hidden
state threaded through. PyTorch runs eagerly, so a "step" is a plain Python
function; nothing is compiled.

In place: the step updates `params` and `opt_state` IN PLACE and returns the
same objects (the JAX step donates its arguments to the same effect). The
returned state is detached: no gradient crosses a chunk boundary.

Not ported yet: `mesh=` (multi-device sharding) and the block-scan
executables (`make_train_block_scan`, `make_eval_block_scan`,
`eval_device_corpus`); they raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.models.generate import cast_float_tree
from msnv_tpu_torch.models.samplernn import predictor_apply
from msnv_tpu_torch.ops.xent import nll_bits_from_logits
from msnv_tpu_torch.tree import tree_leaves, tree_map


def exposure_tuple(train_cfg) -> Optional[tuple]:
    """(ss_prob, input_noise_prob, input_noise_levels) when exposure-bias
    mitigation is enabled in a TrainConfig, else None."""
    if train_cfg is None:
        return None
    if train_cfg.ss_prob <= 0.0 and train_cfg.input_noise_prob <= 0.0:
        return None
    return (float(train_cfg.ss_prob), float(train_cfg.input_noise_prob),
            int(train_cfg.input_noise_levels))


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is not ported yet")


def _forward(params, cfg, compute_dtype, state, data, reset, cond, spk):
    """Logits (f32) and the new state (f32) of one chunk; with
    `compute_dtype` the params are cast (differentiably) and the state goes
    in in that type."""
    if compute_dtype is not None:
        params = cast_float_tree(params, compute_dtype)
        state = [s.to(compute_dtype) for s in state]
    logits, new_state, _latent = predictor_apply(
        params, cfg, data, reset, cond, spk, state, output="logits")
    return logits, [s.to(torch.float32) for s in new_state]


def loss_and_grads(params, cfg: ModelConfig, state, data, reset, target,
                   cond, spk, compute_dtype=None):
    """(loss_bits, new_state, grads) of one chunk; grads is a float32 tree
    in params' layout (zeros where the loss does not depend on a leaf), with
    h0's zeroed when cfg.learn_h0 is false."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        logits, new_state = _forward(leaves, cfg, compute_dtype, state, data,
                                     reset, cond, spk)
        loss = nll_bits_from_logits(logits, target)
    got = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                   allow_unused=True))

    def grad_of(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad_of, leaves)
    return (loss.detach(), state_stop_gradient(new_state),
            freeze_h0_grads(cfg, grads))


def _perturb(params, cfg, compute_dtype, exposure, state, data, reset, cond,
             spk, generator):
    """Exposure-bias mitigation on the TBPTT inputs (targets stay clean):
    input noise jitters input levels with prob noise_prob by up to
    +-noise_levels; scheduled sampling replaces input samples past the
    lookback seed, with prob ss_prob, by draws from the model's own
    teacher-forced prediction (one extra forward, no sequential loop).
    Draws come from `generator`, which lives on data's device."""
    ss_prob, noise_prob, noise_levels = exposure
    lb = cfg.lookback
    dev = data.device
    if noise_prob > 0.0:
        flip = torch.rand(data.shape, generator=generator,
                          device=dev) < noise_prob
        jitter = torch.randint(-noise_levels, noise_levels + 1, data.shape,
                               generator=generator, device=dev,
                               dtype=data.dtype)
        data = torch.where(
            flip, torch.clamp(data + jitter, 0, cfg.q_levels - 1), data)
    if ss_prob > 0.0:
        with torch.no_grad():
            logits, _ = _forward(params, cfg, compute_dtype, state, data,
                                 reset, cond, spk)
        # logits[:, t] predicts target t, which sits at input position
        # lb + t; the LAST target is outside the input window, so only
        # samples[:, :-1] are candidates
        probs = torch.softmax(logits, dim=-1)
        samples = torch.multinomial(
            probs.reshape(-1, probs.shape[-1]), 1,
            generator=generator).reshape(probs.shape[:-1]).to(data.dtype)
        mix = torch.rand(samples[:, :-1].shape, generator=generator,
                         device=dev) < ss_prob
        tail = torch.where(mix, samples[:, :-1], data[:, lb:])
        data = torch.cat([data[:, :lb], tail], dim=1)
    return data


def make_train_step(cfg: ModelConfig, optimizer, mesh=None,
                    compute_dtype=None, exposure: Optional[tuple] = None):
    """Build the train step.

    step(params, opt_state, state, data, reset, target, cond, spk[,
         generator]) -> (params, opt_state, state, loss_bits)

    compute_dtype=torch.bfloat16 is mixed-precision training: f32 master
    params (Adam in f32), forward/backward matmuls in bf16 through a
    differentiable cast, logits and loss in f32. With `exposure` (see
    `exposure_tuple`) the step takes a trailing torch.Generator on the
    data's device and perturbs its inputs first. params and opt_state are
    updated in place.
    """
    _no_mesh(mesh)

    def step(params, opt_state, state, data, reset, target, cond, spk,
             generator=None):
        if exposure is not None:
            data = _perturb(params, cfg, compute_dtype, exposure, state, data,
                            reset, cond, spk, generator)
        loss, new_state, grads = loss_and_grads(
            params, cfg, state, data, reset, target, cond, spk, compute_dtype)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, new_state, loss

    return step


def make_eval_step(cfg: ModelConfig, mesh=None):
    """Evaluation step: step(params, state, data, reset, target, cond, spk)
    -> (loss_bits, new_state)."""
    _no_mesh(mesh)

    @torch.no_grad()
    def step(params, state, data, reset, target, cond, spk):
        logits, new_state, _ = predictor_apply(
            params, cfg, data, reset, cond, spk, state, output="logits")
        return nll_bits_from_logits(logits, target), new_state

    return step


def chunk_slices(corpus, k: int, seq_len: int, overlap_len: int,
                 cond_in_seq: int):
    """Chunk k of a device-resident packed corpus ({"qdata" (B, N) int,
    "cond" (B, F, C), "spk" (K, B)}), sliced as the loader's get_chunk(k)
    does -> (data, reset, target, cond, spk)."""
    start = k * seq_len
    data = corpus["qdata"][:, start:start + seq_len + overlap_len - 1]
    target = corpus["qdata"][:, start + overlap_len:
                             start + overlap_len + seq_len]
    # one-frame cond offset (ref dataset.py:261-266)
    c0 = k * cond_in_seq + 1
    cond = corpus["cond"][:, c0:c0 + cond_in_seq]
    return data, k == 0, target, cond, corpus["spk"][k]


def make_train_step_indexed(cfg: ModelConfig, optimizer, seq_len: int,
                            overlap_len: int, cond_in_seq: int,
                            compute_dtype=None,
                            exposure: Optional[tuple] = None):
    """Train step over a device-resident corpus:

    step(params, opt_state, state, corpus, k[, generator])
      -> (params, opt_state, state, loss_bits)

    The same numbers as make_train_step on the host-sliced tensors (the
    slicing is exact)."""
    core = make_train_step(cfg, optimizer, compute_dtype=compute_dtype,
                           exposure=exposure)

    def step(params, opt_state, state, corpus, k, generator=None):
        data, reset, target, cond, spk = chunk_slices(
            corpus, int(k), seq_len, overlap_len, cond_in_seq)
        return core(params, opt_state, state, data, reset, target, cond, spk,
                    generator)

    return step


def make_eval_step_indexed(cfg: ModelConfig, seq_len: int, overlap_len: int,
                           cond_in_seq: int):
    """Eval step over a device-resident corpus:
    step(params, state, corpus, k) -> (loss_bits, new_state)."""
    core = make_eval_step(cfg)

    def step(params, state, corpus, k):
        data, reset, target, cond, spk = chunk_slices(
            corpus, int(k), seq_len, overlap_len, cond_in_seq)
        return core(params, state, data, reset, target, cond, spk)

    return step


def _block_scan_not_ported(*_args, **_kwargs):
    raise NotImplementedError(
        "the block-scan executables are not ported yet; loop over "
        "make_train_step_indexed / make_eval_step_indexed")


make_train_block_scan = _block_scan_not_ported
make_eval_block_scan = _block_scan_not_ported
eval_device_corpus = _block_scan_not_ported


def state_stop_gradient(state):
    """TBPTT boundary: no grads flow into the carried state
    (ref model.py:348 `.detach()`)."""
    return [s.detach() for s in state]


def freeze_h0_grads(cfg: ModelConfig, grads):
    """learn_h0=False: h0 is a fixed (zero) buffer like the reference's
    register_buffer path (ref model.py:79-83): zero its gradients so the
    optimizer never moves it."""
    if cfg.learn_h0:
        return grads
    for tier in grads["tiers"]:
        tier["h0"] = torch.zeros_like(tier["h0"])
    return grads
