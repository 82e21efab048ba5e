"""Parameters written by the JAX trainer, loaded into the port.

The JAX package's npz checkpoints (training/checkpoint.py) store
each leaf of the saved tree under "leaf:" + its JAX tree_util.keystr path,
e.g. "leaf:['params']['tiers'][0]['h0']", plus a JSON "__meta__" entry. The
port keeps the JAX parameter tree and layouts, so loading is a walk over the
model's template with those key strings rebuilt here — no JAX needed.
"""

from __future__ import annotations

import numpy as np
import torch

from msnv_tpu_torch.config import ModelConfig
from msnv_tpu_torch.device import resolve_device
from msnv_tpu_torch.models.samplernn import init_params

PREFIX = "leaf:['params']"


def _keystr(path) -> str:
    """JAX's tree_util.keystr for a path of dict keys (str) and list
    indices (int)."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(template, fill, path=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, fill, path + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, fill, path + (i,))
                for i, v in enumerate(template)]
    return fill(path, template)


def param_keys(cfg: ModelConfig) -> list:
    """The checkpoint keys of every parameter of `cfg`'s model."""
    template = init_params(cfg, device="meta")
    return [PREFIX + _keystr(path) for path, _ in _leaves(template)]


def params_from_numpy(flat: dict, cfg: ModelConfig, device=None):
    """The port's params from a flat {checkpoint key: array} mapping.

    Every parameter of the model must be present (KeyError names the
    missing key) with the expected shape (ValueError otherwise); other
    entries (optimizer state, TBPTT hidden, "__meta__") are ignored.
    """
    device = resolve_device(device)
    template = init_params(cfg, device="meta")

    def fill(path, t):
        key = PREFIX + _keystr(path)
        if key not in flat:
            raise KeyError(f"checkpoint has no entry {key}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(
                f"shape mismatch at {key}: saved {tuple(arr.shape)} vs "
                f"expected {tuple(t.shape)} — wrong config for this "
                f"checkpoint?")
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    return _rebuild(template, fill)


def load_npz_params(path, cfg: ModelConfig, device=None):
    """Read a JAX-trainer `.npz` checkpoint with numpy alone."""
    keys = set(param_keys(cfg))
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k in keys}
    return params_from_numpy(flat, cfg, device=device)


def params_to_numpy(params) -> dict:
    """The inverse: {checkpoint key: float32 array} for an npz writer."""
    return {PREFIX + _keystr(path): t.detach().float().cpu().numpy()
            for path, t in _leaves(params)}


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
