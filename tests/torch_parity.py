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
