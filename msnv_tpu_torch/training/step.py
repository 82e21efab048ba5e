"""TBPTT train / eval steps.

Port of the JAX package's training/step.py: forward -> NLL-bits loss ->
gradients -> element-wise clip -> Adam -> new params, with the TBPTT hidden
state threaded through. PyTorch runs eagerly, so a "step" is a plain Python
function; nothing is compiled.

In place: the step updates `params` and `opt_state` IN PLACE and returns the
same objects (the JAX step donates its arguments to the same effect). The
returned state is detached: no gradient crosses a chunk boundary.

Device-resident corpus: `chunk_slices` cuts chunk k out of the packed
corpus uploaded once (data/loader.ChunkLoader.device_arrays); the indexed
steps take a chunk index. The JAX package compiles a `lax.scan` over a block
of chunk indices; eager PyTorch has no scan, so a block
(`make_train_block_scan`, `make_eval_block_scan`) is a Python loop over the
indexed steps whose losses are stacked on the device and fetched once: the
same numbers as the indexed steps, bit for bit. `eval_device_corpus` runs the
eval blocks over a freshly uploaded corpus.

Exposure-bias randomness comes from torch.Generators seeded by
`fold_generator` from integers (the seed, the iteration or the epoch and the
chunk index), the counterpart of the JAX key chains, so a resumed run
replays the same stream.

Not ported: `mesh=` (multi-device sharding) raises NotImplementedError
(ROADMAP queue 1.7.4).
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
        raise NotImplementedError("mesh= (multi-device) is not ported yet "
                                  "(ROADMAP queue 1.7.4)")


def _forward(params, cfg, compute_dtype, state, data, reset, cond, spk):
    """Logits (f32), the new state (f32) and the conditioner latent (None
    for the identity head) of one chunk; with `compute_dtype` the params
    are cast (differentiably) and the state goes in in that type."""
    if compute_dtype is not None:
        params = cast_float_tree(params, compute_dtype)
        state = [s.to(compute_dtype) for s in state]
    logits, new_state, latent = predictor_apply(
        params, cfg, data, reset, cond, spk, state, output="logits")
    return logits, [s.to(torch.float32) for s in new_state], latent


def grad_leaves(params):
    """Fresh leaves to differentiate against: params' storage, detached."""
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def grads_like(leaves, grads):
    """A gradient tree in `leaves`' layout from autograd.grad's flat
    results (zeros where a leaf was unused)."""
    got = iter(grads)

    def grad_of(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g

    return tree_map(grad_of, leaves)


def loss_and_grads(params, cfg: ModelConfig, state, data, reset, target,
                   cond, spk, compute_dtype=None):
    """(loss_bits, new_state, grads) of one chunk; grads is a float32 tree
    in params' layout (zeros where the loss does not depend on a leaf), with
    h0's zeroed when cfg.learn_h0 is false."""
    leaves = grad_leaves(params)
    with torch.enable_grad():
        logits, new_state, _ = _forward(leaves, cfg, compute_dtype, state,
                                        data, reset, cond, spk)
        loss = nll_bits_from_logits(logits, target)
    grads = grads_like(leaves, torch.autograd.grad(
        loss, tree_leaves(leaves), allow_unused=True))
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
            logits, _, _ = _forward(params, cfg, compute_dtype, state,
                                    data, reset, cond, spk)
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


_MASK64 = (1 << 64) - 1


def fold_generator(device, *ints) -> torch.Generator:
    """A torch.Generator on `device` seeded from a chain of integers (a
    splitmix64 mix per integer), like jax.random.fold_in chains: the same
    integers give the same stream."""
    h = 0x9E3779B97F4A7C15
    for v in ints:
        h = (h ^ (int(v) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return torch.Generator(device=device).manual_seed(h >> 1)


def make_train_block_scan(cfg: ModelConfig, optimizer, seq_len: int,
                          overlap_len: int, cond_in_seq: int, mesh=None,
                          compute_dtype=None,
                          exposure: Optional[tuple] = None):
    """Multi-step train over a device-resident corpus:

    run_block(params, opt_state, state, corpus, ks[, key])
      -> (params, opt_state, state, losses (len(ks),) on the device)

    The indexed train step for each chunk index of `ks` in order, the
    losses stacked on the device (one fetch per block for the caller). With
    `exposure` it takes a trailing `key`, a tuple of integers; chunk k
    draws from fold_generator(device, *key, k).
    """
    _no_mesh(mesh)
    step = make_train_step_indexed(cfg, optimizer, seq_len, overlap_len,
                                   cond_in_seq, compute_dtype=compute_dtype,
                                   exposure=exposure)

    def run_block(params, opt_state, state, corpus, ks, key=()):
        losses = []
        for k in ks:
            k = int(k)
            extra = ((fold_generator(corpus["qdata"].device, *key, k),)
                     if exposure is not None else ())
            params, opt_state, state, loss = step(params, opt_state, state,
                                                  corpus, k, *extra)
            losses.append(loss)
        return params, opt_state, state, torch.stack(losses)

    return run_block


def make_eval_block_scan(cfg: ModelConfig, seq_len: int, overlap_len: int,
                         cond_in_seq: int, mesh=None):
    """Multi-step eval over a device-resident corpus:
    run_block(params, state, corpus, ks) -> (losses (len(ks),), state)."""
    _no_mesh(mesh)
    step = make_eval_step_indexed(cfg, seq_len, overlap_len, cond_in_seq)

    def run_block(params, state, corpus, ks):
        losses = []
        for k in ks:
            loss, state = step(params, state, corpus, int(k))
            losses.append(loss)
        return torch.stack(losses), state

    return run_block


def eval_device_corpus(cfg: ModelConfig, params, state, loader,
                       scan_block: int = 16):
    """Block evaluation over a freshly uploaded device corpus (on the
    state's device) -> (mean NLL bits, final state). Used by the evaluate
    CLI; Trainer.evaluate keeps the uploaded corpora across epochs. The
    corpus is released when this frame returns."""
    corpus_dev = loader.device_arrays(state[0].device)
    scan = make_eval_block_scan(cfg, loader.seq_len, loader.overlap_len,
                                loader.cond_in_seq)
    ks = list(range(len(loader)))
    losses = []
    for i in range(0, len(ks), scan_block):
        blk_losses, state = scan(params, state, corpus_dev,
                                 ks[i:i + scan_block])
        losses.append(blk_losses)
    nll = float(torch.cat(losses).mean()) if losses else 0.0
    return nll, state


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
