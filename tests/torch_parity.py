"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Weights cross from the JAX package to the port as numpy arrays under the
checkpoint keys ("leaf:" + jax.tree_util.keystr(path)), the format the JAX
trainer writes, through msnv_tpu_torch.interop.params_from_numpy.
"""

import dataclasses

import jax
import numpy as np
import torch

from msnv_tpu.config import ModelConfig, preset
from msnv_tpu.models.samplernn import init_params as jax_init_params
from msnv_tpu_torch.config import ModelConfig as TorchModelConfig
from msnv_tpu_torch.interop import params_from_numpy

# the port's tests run at tiny widths inside several pytest workers that
# share the CPU with JAX: one intra-op thread each avoids oversubscription
torch.set_num_threads(1)


def torch_cfg(cfg: ModelConfig) -> TorchModelConfig:
    """The port's ModelConfig with the same fields."""
    return TorchModelConfig(**dataclasses.asdict(cfg))


def flat_numpy(params) -> dict:
    """{checkpoint key: array} of a JAX param tree saved as {"params": .}."""
    flat, _ = jax.tree_util.tree_flatten_with_path({"params": params})
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


def to_torch(params, cfg: ModelConfig):
    """JAX params -> the port's params on the CPU (float32)."""
    return params_from_numpy(flat_numpy(params), torch_cfg(cfg),
                             device="cpu")


def both_params(cfg: ModelConfig, seed: int = 0):
    """(JAX params, the same weights in the port)."""
    params = jax_init_params(jax.random.PRNGKey(seed), cfg)
    return params, to_torch(params, cfg)


def t(x, dtype=None):
    """numpy/JAX array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def narrow_samplernn(dim: int = 32) -> ModelConfig:
    """The canonical `samplernn` preset at a narrow width."""
    return dataclasses.replace(preset("samplernn").model, dim=dim)


def tiny() -> ModelConfig:
    return preset("tiny_unconditional").model


def corpus_arrays(cfg: ModelConfig, batch: int, seq_len: int, n_chunks: int,
                  seed: int = 0) -> dict:
    """A packed corpus from a numpy seed ({data, cond, spk, audio_id,
    min_cond, max_cond, spk_ids}) with exactly `n_chunks` full TBPTT
    windows per lane: float64 audio in [-0.95, 0.95], conditioner frames
    in [0, 1), speaker runs of 7 frames."""
    rng = np.random.RandomState(seed)
    lb = cfg.lookback
    lane_len = n_chunks * seq_len + lb
    frames = lane_len // cfg.cond_len + 1
    spk = (np.arange(frames)[None, :] // 7 + np.arange(batch)[:, None])
    return {"data": rng.uniform(-0.95, 0.95, (batch, lane_len)),
            "cond": rng.rand(batch, frames, cfg.effective_cond_dim),
            "spk": (spk % cfg.spk_dim).astype(np.int64),
            "audio_id": np.zeros((batch, frames), np.int64),
            "min_cond": np.zeros(cfg.effective_cond_dim),
            "max_cond": np.ones(cfg.effective_cond_dim),
            "spk_ids": np.asarray([f"{71 + s}" for s in range(cfg.spk_dim)])}


def both_loaders(cfg: ModelConfig, batch: int, seq_len: int, n_chunks: int,
                 seed: int = 0):
    """(port ChunkLoader, JAX ChunkLoader) over one corpus_arrays corpus."""
    from msnv_tpu.data.corpus import Corpus as JCorpus
    from msnv_tpu.data.loader import ChunkLoader as JLoader
    from msnv_tpu_torch.data.corpus import Corpus as TCorpus
    from msnv_tpu_torch.data.loader import ChunkLoader as TLoader
    arrays = corpus_arrays(cfg, batch, seq_len, n_chunks, seed)
    geo = (seq_len, cfg.lookback, cfg.cond_len, cfg.q_levels, cfg.ulaw)
    tl = TLoader(TCorpus(**arrays), *geo)
    jl = JLoader(JCorpus(**arrays), *geo)
    assert len(tl) == len(jl) == n_chunks
    return tl, jl
