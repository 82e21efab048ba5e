"""Data-parallel batched generation and streaming over a device mesh.

The port's counterpart of the JAX package's parallel/generate.py. A batch
of utterances is sharded along the mesh's 'data' axis: every rank (one
process per GPU, parallel/mesh.py) runs the port's generate_fn /
streaming_fn on its B / n_data lanes, so the sample-window kernel runs
there, and no collective runs on the hot path; the results are
all-gathered at the end, so every rank holds the (B, ...) arrays that the
JAX package's sharded global arrays hold.

Contract (the JAX package's): each shard draws from its own generator,
folded from the caller's seed and its data index
(`fold_generator(device, seed, data_index)`, the counterpart of
`jax.random.fold_in(key, idx)`), so a sharded batch is defined as n_data
independent local generators: shard i equals a local run on its lanes with
that generator, sample for sample. Every rank takes the same global
inputs and the same params (`broadcast_tree`; the serving service sees
to it); B must divide by the 'data' size. Ranks that share a data index
(over 'model') generate the same lanes.
"""

from __future__ import annotations

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.models.generate import generate_fn, streaming_fn
from msnv_tpu_torch.parallel.mesh import (batch_sharding, check_mesh,
                                          gather_lanes)
from msnv_tpu_torch.training.step import fold_generator


def _check_batch(mesh, b: int) -> None:
    shards = mesh.shape["data"]
    if b % shards:
        raise ValueError(
            f"batch {b} must divide by the mesh 'data' axis size {shards} "
            f"(each shard carries B/shards lanes)")


def shard_generator(mesh, seed: int):
    """This rank's generator: fold_generator(mesh.device, seed,
    data_index)."""
    return fold_generator(mesh.device, seed, mesh.data_index)


def sharded_generate_fn(params, cfg: ModelConfig, mesh, compute_dtype=None,
                        use_kernel=False, temperature=1.0, gather=True):
    """Build generate(cond, spk, seed=0) sharded over mesh axis 'data'.

    cond (B, frames, C) and spk (B,) or (B, spk_dim) are the global batch
    (the same on every rank, on the params' device); params are the full
    tree, replicated. Returns (audio, sequences), (B, ...) on every rank;
    with gather=False this rank's lanes (B / n_data, ...), which the caller
    gathers with gather_lanes (the serving mesh votes in between,
    parallel/serve.py).
    """
    check_mesh(mesh)
    inner = generate_fn(params, cfg, compute_dtype=compute_dtype,
                        use_kernel=use_kernel, temperature=temperature)
    lanes = batch_sharding(mesh)

    def generate(cond, spk, seed: int = 0):
        _check_batch(mesh, cond.shape[0])
        audio, seq = inner(lanes.local(cond), lanes.local(spk),
                           shard_generator(mesh, seed))
        if not gather:
            return audio, seq
        return gather_lanes(mesh, audio), gather_lanes(mesh, seq)

    return generate


def sharded_generate_fn_dynamic(cfg: ModelConfig, mesh, compute_dtype=None,
                                use_kernel=False, temperature=1.0):
    """sharded_generate_fn with params as a CALL argument:
    generate(params, cond, spk, seed=0) -> (audio, sequences). The same
    contract; the generator is built on each call from the params given."""
    check_mesh(mesh)

    def generate(params, cond, spk, seed: int = 0):
        return sharded_generate_fn(
            params, cfg, mesh, compute_dtype=compute_dtype,
            use_kernel=use_kernel, temperature=temperature)(cond, spk, seed)

    return generate


def sharded_streaming_fn(params, cfg: ModelConfig, mesh,
                         frames_per_push: int = 1, compute_dtype=None,
                         use_kernel=False, temperature=1.0):
    """Streaming push sharded over mesh axis 'data': the multi-device form
    of models.generate.streaming_fn, one lane-batched stream state with its
    lanes over the ranks.

    Returns (init_state, push):
      init_state(spk (B,), seed=0) -> carry of this rank's lanes, holding
        its folded generator (B must divide by the 'data' size);
      push(carry, cond (B, C) or (B, K, C), the global batch)
        -> (carry, audio (B, K*lookback), samples (same)), all-gathered.

    Per-shard equality against local streaming_fn pushes on the shard's
    lanes with the folded generator is exact.
    """
    check_mesh(mesh)
    init_local, push_local = streaming_fn(
        params, cfg, compute_dtype=compute_dtype, use_kernel=use_kernel,
        frames_per_push=frames_per_push, temperature=temperature)
    lanes = batch_sharding(mesh)

    def init_state(spk, seed: int = 0):
        _check_batch(mesh, spk.shape[0])
        local = lanes.local(spk)
        return init_local(local.shape[0], local, shard_generator(mesh, seed))

    def push(carry, cond):
        _check_batch(mesh, cond.shape[0])
        carry, audio, samples = push_local(carry, lanes.local(cond))
        return carry, gather_lanes(mesh, audio), gather_lanes(mesh, samples)

    return init_state, push
