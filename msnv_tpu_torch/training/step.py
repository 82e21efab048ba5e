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

Over a device mesh (parallel/mesh.py; one process per GPU), every builder
takes `mesh=` and `specs=`, the full params' `param_sharding(mesh, params)`
(needed when the mesh has a 'model' axis; None replicates every leaf), and
returns the sharded step. It takes this rank's storage of the params and of
the optimizer state (`shard_params`; the params themselves when n_model is
1), its lanes of the batch or corpus and of the tier state, and returns the
global loss. Each rank runs the single-device step on its lanes; what JAX
computes from the global batch is computed after the reduction over
'data', in JAX's order: the loss (the mean of the shard means), the
gradient (sum / n_data), then the element-wise clip and Adam, on the slice
the rank stores. Every rank gets the same reduced bits, so replicas that
start equal stay bit-identical: the replicas must be equal when the first
step runs (`broadcast_tree`; Trainer sees to it). Exposure-bias draws are
made at the global batch's shape from the step's generator and sliced, so
a sharded run draws what the single-device run draws.

While a torch.profiler records, the train step times its optimizer update
on the device as the section `train.optim` (utils/profiling.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.models.generate import cast_float_tree
from msnv_tpu_torch.models.samplernn import predictor_apply
from msnv_tpu_torch.ops.xent import nll_bits_from_logits
from msnv_tpu_torch.parallel.mesh import (batch_sharding, check_mesh,
                                          corpus_sharding, data_mean,
                                          gather_params, reduce_gradients)
from msnv_tpu_torch.tree import tree_leaves, tree_map
from msnv_tpu_torch.utils import profiling


def exposure_tuple(train_cfg) -> Optional[tuple]:
    """(ss_prob, input_noise_prob, input_noise_levels) when exposure-bias
    mitigation is enabled in a TrainConfig, else None."""
    if train_cfg is None:
        return None
    if train_cfg.ss_prob <= 0.0 and train_cfg.input_noise_prob <= 0.0:
        return None
    return (float(train_cfg.ss_prob), float(train_cfg.input_noise_prob),
            int(train_cfg.input_noise_levels))


def check_mesh_specs(mesh, specs) -> None:
    """Refuse a mesh that `make_mesh` did not make, and a 'model' axis
    without the specs that say which leaves it shards."""
    check_mesh(mesh)
    if mesh is not None and specs is None and mesh.shape["model"] > 1:
        raise ValueError(
            f"a mesh with a 'model' axis of {mesh.shape['model']} needs "
            f"specs=param_sharding(mesh, params) of the full params")


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
             spk, generator, mesh=None):
    """Exposure-bias mitigation on the TBPTT inputs (targets stay clean):
    input noise jitters input levels with prob noise_prob by up to
    +-noise_levels; scheduled sampling replaces input samples past the
    lookback seed, with prob ss_prob, by draws from the model's own
    teacher-forced prediction (one extra forward, no sequential loop; a
    draw is the inverse CDF of the softmax at a uniform number). Draws
    come from `generator`, which lives on data's device, at the GLOBAL
    batch's shape: over a mesh each rank keeps its lanes of them."""
    ss_prob, noise_prob, noise_levels = exposure
    lb = cfg.lookback
    dev = data.device
    n_data = 1 if mesh is None else mesh.shape["data"]
    local = (lambda x: x) if mesh is None else batch_sharding(mesh).local

    def draw(fn, *args, shape, **kw):
        shape = (shape[0] * n_data,) + tuple(shape[1:])
        return local(fn(*args, shape, generator=generator, device=dev, **kw))

    if noise_prob > 0.0:
        flip = draw(torch.rand, shape=data.shape) < noise_prob
        jitter = draw(torch.randint, -noise_levels, noise_levels + 1,
                      shape=data.shape, dtype=data.dtype)
        data = torch.where(
            flip, torch.clamp(data + jitter, 0, cfg.q_levels - 1), data)
    if ss_prob > 0.0:
        with torch.no_grad():
            logits, _, _ = _forward(params, cfg, compute_dtype, state,
                                    data, reset, cond, spk)
        # logits[:, t] predicts target t, which sits at input position
        # lb + t; the LAST target is outside the input window, so only
        # samples[:, :-1] are candidates
        cdf = torch.softmax(logits, dim=-1).cumsum(-1)
        u = draw(torch.rand, shape=cdf.shape[:-1])
        samples = torch.searchsorted(cdf, (u * cdf[..., -1])[..., None])
        samples = samples[..., 0].clamp(max=cfg.q_levels - 1).to(data.dtype)
        mix = draw(torch.rand, shape=samples[:, :-1].shape) < ss_prob
        tail = torch.where(mix, samples[:, :-1], data[:, lb:])
        data = torch.cat([data[:, :lb], tail], dim=1)
    return data


def _train_core(cfg, optimizer, compute_dtype, exposure, mesh, specs):
    """The train step; over `mesh` it takes this rank's storage and lanes
    (see the module docstring)."""

    def step(params, opt_state, state, data, reset, target, cond, spk,
             generator=None):
        full = params if mesh is None else gather_params(mesh, params, specs)
        if exposure is not None:
            data = _perturb(full, cfg, compute_dtype, exposure, state, data,
                            reset, cond, spk, generator, mesh)
        loss, new_state, grads = loss_and_grads(
            full, cfg, state, data, reset, target, cond, spk, compute_dtype)
        if mesh is not None:
            grads, loss = reduce_gradients(mesh, grads, specs, loss)
        with profiling.section("train.optim", data.device):
            params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, new_state, loss

    return step


def _eval_core(cfg, mesh, specs):
    @torch.no_grad()
    def step(params, state, data, reset, target, cond, spk):
        full = params if mesh is None else gather_params(mesh, params, specs)
        logits, new_state, _ = predictor_apply(
            full, cfg, data, reset, cond, spk, state, output="logits")
        loss = nll_bits_from_logits(logits, target)
        if mesh is not None:
            (loss,) = data_mean(mesh, [loss])
        return loss, new_state

    return step


def make_train_step(cfg: ModelConfig, optimizer, mesh=None,
                    compute_dtype=None, exposure: Optional[tuple] = None,
                    specs=None):
    """Build the train step.

    step(params, opt_state, state, data, reset, target, cond, spk[,
         generator]) -> (params, opt_state, state, loss_bits)

    compute_dtype=torch.bfloat16 is mixed-precision training: f32 master
    params (Adam in f32), forward/backward matmuls in bf16 through a
    differentiable cast, logits and loss in f32. With `exposure` (see
    `exposure_tuple`) the step takes a trailing torch.Generator on the
    data's device and perturbs its inputs first. params and opt_state are
    updated in place. With `mesh` (and `specs`), the sharded step (module
    docstring).
    """
    check_mesh_specs(mesh, specs)
    return _train_core(cfg, optimizer, compute_dtype, exposure, mesh, specs)


def make_eval_step(cfg: ModelConfig, mesh=None, specs=None):
    """Evaluation step: step(params, state, data, reset, target, cond, spk)
    -> (loss_bits, new_state); with `mesh` (and `specs`), the sharded step,
    whose loss is the global one."""
    check_mesh_specs(mesh, specs)
    return _eval_core(cfg, mesh, specs)


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


def _train_indexed(cfg, optimizer, geo, compute_dtype, exposure, mesh,
                   specs):
    core = _train_core(cfg, optimizer, compute_dtype, exposure, mesh, specs)

    def step(params, opt_state, state, corpus, k, generator=None):
        data, reset, target, cond, spk = chunk_slices(corpus, int(k), *geo)
        return core(params, opt_state, state, data, reset, target, cond, spk,
                    generator)

    return step


def _eval_indexed(cfg, geo, mesh, specs):
    core = _eval_core(cfg, mesh, specs)

    def step(params, state, corpus, k):
        data, reset, target, cond, spk = chunk_slices(corpus, int(k), *geo)
        return core(params, state, data, reset, target, cond, spk)

    return step


def make_train_step_indexed(cfg: ModelConfig, optimizer, seq_len: int,
                            overlap_len: int, cond_in_seq: int,
                            compute_dtype=None,
                            exposure: Optional[tuple] = None, mesh=None,
                            specs=None):
    """Train step over a device-resident corpus:

    step(params, opt_state, state, corpus, k[, generator])
      -> (params, opt_state, state, loss_bits)

    The same numbers as make_train_step on the host-sliced tensors (the
    slicing is exact). With `mesh` (and `specs`), the sharded step; the
    corpus holds this rank's lanes (loader.device_arrays(shardings=))."""
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    return _train_indexed(cfg, optimizer, geo, compute_dtype, exposure, mesh,
                          specs)


def make_eval_step_indexed(cfg: ModelConfig, seq_len: int, overlap_len: int,
                           cond_in_seq: int, mesh=None, specs=None):
    """Eval step over a device-resident corpus:
    step(params, state, corpus, k) -> (loss_bits, new_state); with `mesh`
    (and `specs`), the sharded step."""
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    return _eval_indexed(cfg, geo, mesh, specs)


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
                          exposure: Optional[tuple] = None, specs=None):
    """Multi-step train over a device-resident corpus:

    run_block(params, opt_state, state, corpus, ks[, key])
      -> (params, opt_state, state, losses (len(ks),) on the device)

    The indexed train step for each chunk index of `ks` in order, the
    losses stacked on the device (one fetch per block for the caller). With
    `exposure` it takes a trailing `key`, a tuple of integers; chunk k
    draws from fold_generator(device, *key, k). With `mesh` (and `specs`),
    the sharded form.
    """
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    step = _train_indexed(cfg, optimizer, geo, compute_dtype, exposure, mesh,
                          specs)

    def run_block(params, opt_state, state, corpus, ks, key=()):
        losses = []
        for k in ks:
            k = int(k)
            extra = ((fold_generator(corpus["qdata"].device, *key, k),)
                     if exposure is not None else ())
            params, opt_state, state, loss = step(
                params, opt_state, state, corpus, k, *extra)
            losses.append(loss)
        return params, opt_state, state, torch.stack(losses)

    return run_block


def _eval_block(cfg, geo, mesh, specs):
    step = _eval_indexed(cfg, geo, mesh, specs)

    def run_block(params, state, corpus, ks):
        losses = []
        for k in ks:
            loss, state = step(params, state, corpus, int(k))
            losses.append(loss)
        return torch.stack(losses), state

    return run_block


def make_eval_block_scan(cfg: ModelConfig, seq_len: int, overlap_len: int,
                         cond_in_seq: int, mesh=None, specs=None):
    """Multi-step eval over a device-resident corpus:
    run_block(params, state, corpus, ks) -> (losses (len(ks),), state);
    with `mesh` (and `specs`), the sharded form."""
    check_mesh_specs(mesh, specs)
    geo = (seq_len, overlap_len, cond_in_seq)
    return _eval_block(cfg, geo, mesh, specs)


def eval_device_corpus(cfg: ModelConfig, params, state, loader,
                       scan_block: int = 16, mesh=None):
    """Block evaluation over a freshly uploaded device corpus (on the
    state's device) -> (mean NLL bits, final state). Used by the evaluate
    CLI; Trainer.evaluate keeps the uploaded corpora across epochs. The
    corpus is released when this frame returns. `params` is the full tree;
    with `mesh`, `state` holds this rank's lanes, the corpus is uploaded as
    this rank's lanes and the loss is the global mean."""
    check_mesh(mesh)
    geo = (loader.seq_len, loader.overlap_len, loader.cond_in_seq)
    shardings = None if mesh is None else corpus_sharding(mesh)
    corpus_dev = loader.device_arrays(state[0].device, shardings=shardings)
    scan = _eval_block(cfg, geo, mesh, None)
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
