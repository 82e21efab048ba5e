"""Parameters written by the JAX trainer, loaded into the port.

The JAX package's npz checkpoints (training/checkpoint.py) store
each leaf of the saved tree under "leaf:" + its JAX tree_util.keystr path,
e.g. "leaf:['params']['tiers'][0]['h0']", plus a JSON "__meta__" entry. The
port keeps the JAX parameter tree and layouts, so loading is a walk over the
model's template with those key strings rebuilt here — no JAX needed. The
GAN variant's discriminator and its optimizer state sit under
['disc_params'] and ['disc_opt_state'].
"""

from __future__ import annotations

import numpy as np
import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.device import resolve_device
from msnv_tpu_torch.models.discriminator import discriminator_init
from msnv_tpu_torch.models.samplernn import init_params
from msnv_tpu_torch.tree import keystr, leaves_with_paths, map_with_paths

PREFIX = "leaf:['params']"
DISC_PREFIX = "leaf:['disc_params']"


def param_keys(cfg: ModelConfig) -> list:
    """The checkpoint keys of every parameter of `cfg`'s model."""
    template = init_params(cfg, device="meta")
    return [PREFIX + keystr(path) for path, _ in leaves_with_paths(template)]


def _from_numpy(flat: dict, template, prefix: str, device):
    """`template`'s tree filled from {prefix + keystr(path): array}."""
    device = resolve_device(device)

    def fill(path, t):
        key = prefix + keystr(path)
        if key not in flat:
            raise KeyError(f"checkpoint has no entry {key}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {key}: saved {tuple(arr.shape)} vs "
                f"expected {tuple(t.shape)} — wrong config for this "
                f"checkpoint?")
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    return map_with_paths(fill, template)


def _to_numpy(tree, prefix: str) -> dict:
    return {prefix + keystr(path): t.detach().float().cpu().numpy()
            for path, t in leaves_with_paths(tree)}


def params_from_numpy(flat: dict, cfg: ModelConfig, device=None):
    """The port's params from a flat {checkpoint key: array} mapping.

    Every parameter of the model must be present (KeyError names the
    missing key) with the expected shape (ValueError otherwise); other
    entries (optimizer state, TBPTT hidden, "__meta__") are ignored.
    """
    return _from_numpy(flat, init_params(cfg, device="meta"), PREFIX, device)


def load_npz_params(path, cfg: ModelConfig, device=None):
    """Read a JAX-trainer `.npz` checkpoint with numpy alone."""
    keys = set(param_keys(cfg))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k in keys}
    return params_from_numpy(flat, cfg, device=device)


def params_to_numpy(params) -> dict:
    """The inverse: {checkpoint key: float32 array} for an npz writer."""
    return _to_numpy(params, PREFIX)


def opt_state_to_numpy(opt_state) -> dict:
    """{"count": int, "mu": {key: array}, "nu": {key: array}} of the
    optimizer state of training/optim.py, the moments under their
    parameters' checkpoint keys."""
    return {"count": int(opt_state["count"]),
            "mu": params_to_numpy(opt_state["mu"]),
            "nu": params_to_numpy(opt_state["nu"])}


def opt_state_from_numpy(flat: dict, cfg: ModelConfig, device=None):
    """The inverse of `opt_state_to_numpy`."""
    return {"count": int(flat["count"]),
            "mu": params_from_numpy(flat["mu"], cfg, device=device),
            "nu": params_from_numpy(flat["nu"], cfg, device=device)}


# --------------------------------------------------------------------------
# The GAN variant's speaker discriminator, under ['disc_params'] and
# ['disc_opt_state'] in the JAX trainer's checkpoints
# --------------------------------------------------------------------------

def disc_params_from_numpy(flat: dict, spk_dim: int, channels: int,
                           device=None):
    """The discriminator's params (models/discriminator.py) from a flat
    {"leaf:['disc_params']...": array} mapping; errors as
    params_from_numpy's."""
    template = discriminator_init(None, spk_dim, channels, device="meta")
    return _from_numpy(flat, template, DISC_PREFIX, device)


def disc_params_to_numpy(disc_params) -> dict:
    """The inverse: {checkpoint key: float32 array}."""
    return _to_numpy(disc_params, DISC_PREFIX)


def disc_opt_state_to_numpy(opt_state) -> dict:
    """`opt_state_to_numpy` of the discriminator's optimizer state."""
    return {"count": int(opt_state["count"]),
            "mu": disc_params_to_numpy(opt_state["mu"]),
            "nu": disc_params_to_numpy(opt_state["nu"])}


def disc_opt_state_from_numpy(flat: dict, spk_dim: int, channels: int,
                              device=None):
    """The inverse of `disc_opt_state_to_numpy`."""
    return {"count": int(flat["count"]),
            "mu": disc_params_from_numpy(flat["mu"], spk_dim, channels,
                                         device),
            "nu": disc_params_from_numpy(flat["nu"], spk_dim, channels,
                                         device)}
