"""Parameters written by the JAX trainer, loaded into the port; and the
original repository's PyTorch checkpoints, both ways.

The JAX package's npz checkpoints (training/checkpoint.py) store
each leaf of the saved tree under "leaf:" + its JAX tree_util.keystr path,
e.g. "leaf:['params']['tiers'][0]['h0']", plus a JSON "__meta__" entry. The
port keeps the JAX parameter tree and layouts, so loading is a walk over the
model's template with those key strings rebuilt here — no JAX needed. The
GAN variant's discriminator and its optimizer state sit under
['disc_params'] and ['disc_opt_state'].

`params_from_reference_state_dict` / `reference_state_dict_from_params`
map the original repository's layout (its Predictor-wrapped SampleRNN
state_dict, key prefix `model.`) to the port's params and back, as the
JAX package's interop.py does (its module docstring has the layout table):
Conv1d weights (out, in, 1) are dense (out, in), the upsampler's
ConvTranspose1d (in, out, k) is (in, k, out) and its bias (out, k) is
(k, out), the MLP's input Conv1d (dim, q, fs0) is (fs0, q, dim); a
weight-normed conv (weight_v, weight_g) is read as its effective weight,
and the upsampler, which the original always weight-norms, is written as
v and g.
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


# --------------------------------------------------------------------------
# The original repository's PyTorch checkpoints
# --------------------------------------------------------------------------

def _norm0(v: np.ndarray) -> np.ndarray:
    """Per-dim-0 L2 norm, keepdims (torch weight_norm dim=0 convention)."""
    return np.sqrt((v.reshape(v.shape[0], -1) ** 2).sum(axis=1)).reshape(
        (v.shape[0],) + (1,) * (v.ndim - 1))


def _conv_weight(sd: dict, prefix: str) -> np.ndarray:
    """Effective conv weight, whether saved plain or weight-normed."""
    if prefix + ".weight" in sd:
        return sd[prefix + ".weight"]
    v = sd[prefix + ".weight_v"]
    return v * (sd[prefix + ".weight_g"].reshape(_norm0(v).shape)
                / _norm0(v))


def _check_reference_cfg(cfg: ModelConfig, what: str):
    if cfg.variant != "identity":
        raise ValueError("interop supports the canonical 'identity' head; "
                         "gan/bottleneck reference variants live on "
                         "branches with different module layouts")
    if cfg.weight_norm:
        raise ValueError(f"{what} with weight_norm=false: weight-normed "
                         "reference checkpoints are reconstructed as "
                         "effective weights (numerically identical "
                         "forward)")


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def params_from_reference_state_dict(sd: dict, cfg: ModelConfig,
                                     device=None):
    """The original repository's state_dict (torch tensors or numpy) -> the
    port's params on `device` (float32).

    Raises KeyError naming the first missing reference key (wrong
    frame_sizes/n_rnn/variant for this checkpoint)."""
    _check_reference_cfg(cfg, "import")
    device = resolve_device(device)
    sd = {k: _host(v) for k, v in sd.items()}
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}

    def arr(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(
            device)

    def dense(prefix):
        return {"w": arr(_conv_weight(sd, prefix)[:, :, 0]),
                "b": arr(sd[prefix + ".bias"])}

    tiers = []
    for t in range(cfg.n_tiers):
        p = f"frame_level_rnns.{t}"
        tier = {
            "h0": arr(sd[f"{p}.h0"]),
            "input_expand": dense(f"{p}.input_expand"),
            "gru": [{"w_ih": arr(sd[f"{p}.rnn.weight_ih_l{n}"]),
                     "w_hh": arr(sd[f"{p}.rnn.weight_hh_l{n}"]),
                     "b_ih": arr(sd[f"{p}.rnn.bias_ih_l{n}"]),
                     "b_hh": arr(sd[f"{p}.rnn.bias_hh_l{n}"])}
                    for n in range(cfg.n_rnn)],
            "upsample": {
                "w": arr(np.transpose(
                    _conv_weight(sd, f"{p}.upsampling.conv_t"), (0, 2, 1))),
                "bias": arr(sd[f"{p}.upsampling.bias"].T),
            },
        }
        if t == cfg.n_tiers - 1:    # the top tier is the conditioned one
            tier["conditioner"] = {"expand": dense(f"{p}.cond_expand")}
            tier["spk_embedding"] = arr(sd[f"{p}.spk_embedding.weight"])
            tier["spk_expand"] = dense(f"{p}.spk_expand")
        tiers.append(tier)
    m = "sample_level_mlp"
    mlp = {"embedding": arr(sd[f"{m}.embedding.weight"]),
           "conv_in": arr(np.transpose(_conv_weight(sd, f"{m}.input"),
                                       (2, 1, 0))),
           "hidden": dense(f"{m}.hidden"),
           "out": dense(f"{m}.output")}
    return {"tiers": tiers, "mlp": mlp}


def reference_state_dict_from_params(params, cfg: ModelConfig) -> dict:
    """The port's params -> the original repository's state_dict (numpy
    float32, `model.` prefix; torch.save it as torch tensors for a file its
    load_state_dict accepts)."""
    _check_reference_cfg(cfg, "export")
    sd = {}

    def dense(prefix, p):
        sd[prefix + ".weight"] = _host(p["w"])[:, :, None]
        sd[prefix + ".bias"] = _host(p["b"])

    for t, tier in enumerate(params["tiers"]):
        p = f"model.frame_level_rnns.{t}"
        sd[f"{p}.h0"] = _host(tier["h0"])
        dense(f"{p}.input_expand", tier["input_expand"])
        if "conditioner" in tier:
            dense(f"{p}.cond_expand", tier["conditioner"]["expand"])
            sd[f"{p}.spk_embedding.weight"] = _host(tier["spk_embedding"])
            dense(f"{p}.spk_expand", tier["spk_expand"])
        for n, layer in enumerate(tier["gru"]):
            sd[f"{p}.rnn.weight_ih_l{n}"] = _host(layer["w_ih"])
            sd[f"{p}.rnn.weight_hh_l{n}"] = _host(layer["w_hh"])
            sd[f"{p}.rnn.bias_ih_l{n}"] = _host(layer["b_ih"])
            sd[f"{p}.rnn.bias_hh_l{n}"] = _host(layer["b_hh"])
        w_t = np.transpose(_host(tier["upsample"]["w"]), (0, 2, 1))
        sd[f"{p}.upsampling.conv_t.weight_v"] = w_t
        sd[f"{p}.upsampling.conv_t.weight_g"] = _norm0(w_t)
        sd[f"{p}.upsampling.bias"] = _host(tier["upsample"]["bias"]).T
    mlp = params["mlp"]
    m = "model.sample_level_mlp"
    sd[f"{m}.embedding.weight"] = _host(mlp["embedding"])
    sd[f"{m}.input.weight"] = np.transpose(_host(mlp["conv_in"]), (2, 1, 0))
    dense(f"{m}.hidden", mlp["hidden"])
    dense(f"{m}.output", mlp["out"])
    return sd
