"""The port's checkpoints against the JAX package's, on the CPU: one .npz
format for both packages.

A checkpoint written by the port loads in msnv_tpu.training.checkpoint with
the JAX Trainer's checkpoint_state() template, every leaf bit-equal and the
meta equal, and the other way round, for each preset the port supports
(the identity head: tiny_unconditional, single_speaker_cond, samplernn; at
dim 32). Greedy audio generated from the crossed weights is equal. The
manager's retention, best-loss recovery and error messages are the JAX
module's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import preset
from msnv_tpu.models.generate import generate_fn as jax_generate_fn
from msnv_tpu.training import checkpoint as jckpt
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.config import ExperimentConfig as TorchExperimentConfig
from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
from msnv_tpu_torch.models.generate import generate_fn
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.trainer import Trainer
from msnv_tpu_torch.tree import tree_map

from torch_parity import both_loaders, both_params, torch_cfg

PORTED_PRESETS = ("tiny_unconditional", "single_speaker_cond", "samplernn")
META = {"epoch": 7, "iteration": 123, "chunk": 5, "val_loss": 1.25,
        "tag": "exp:x"}


def _exp(name):
    exp = preset(name)
    return dataclasses.replace(exp, model=dataclasses.replace(exp.model,
                                                              dim=32))


def _port_exp(exp):
    return TorchExperimentConfig(
        exp=exp.exp, model=torch_cfg(exp.model),
        train=TorchTrainConfig(**dataclasses.asdict(exp.train)))


def _trainers(name, seed=0):
    """(port Trainer, JAX Trainer) from the same weights on one corpus."""
    exp = _exp(name)
    m = exp.model
    tl, jl = both_loaders(m, 2, 2 * m.lookback, 2)
    jp, tp = both_params(m, seed)
    jt = JaxTrainer(exp, jp, jax_make_optimizer(exp.train), jl,
                    device_corpus=False)
    pexp = _port_exp(exp)
    tt = Trainer(pexp, tp, make_optimizer(pexp.train), tl,
                 device_corpus=False)
    return tt, jt


def _random_port_state(trainer, seed):
    g = torch.Generator().manual_seed(seed)
    state = trainer.checkpoint_state()
    state = tree_map(lambda x: 4321 if isinstance(x, int) else
                     torch.randn(x.shape, generator=g), state)
    return state


def _jax_flat(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


def _port_flat(state):
    return tckpt.flatten_state(state)


@pytest.mark.parametrize("name", PORTED_PRESETS)
def test_port_checkpoint_loads_in_jax(name, tmp_path):
    tt, jt = _trainers(name)
    state = _random_port_state(tt, seed=1)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, state, META)
    assert not os.path.exists(path + ".tmp")
    loaded, meta = jckpt.load_checkpoint(path, jt.checkpoint_state())
    assert meta == META
    got, want = _jax_flat(loaded), _port_flat(state)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype or k.endswith(".count"), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert loaded["opt_state"][1][0].count.dtype == jnp.int32
    assert int(loaded["opt_state"][1][0].count) == 4321


@pytest.mark.parametrize("name", PORTED_PRESETS)
def test_jax_checkpoint_loads_in_port(name, tmp_path):
    tt, jt = _trainers(name)
    rng = np.random.RandomState(2)
    state = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(x.dtype)
                              if x.dtype == jnp.float32 else
                              np.asarray(77, x.dtype).reshape(x.shape)),
        jt.checkpoint_state())
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, state, META)
    loaded, meta = tckpt.load_checkpoint(path, tt.checkpoint_state())
    assert meta == META
    assert loaded["opt_state"]["count"] == 77
    got, want = _port_flat(loaded), _jax_flat(state)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the restored trainer holds the loaded tensors
    tt.restore(loaded, meta)
    assert tt.epochs == 7 and tt.iterations == 123 and tt.start_chunk == 5
    assert tt.params is loaded["params"]


def test_partial_template_and_device(tmp_path):
    tt, _ = _trainers("tiny_unconditional")
    path = str(tmp_path / "p.npz")
    tckpt.save_checkpoint(path, tt.checkpoint_state(), {"epoch": 1})
    from msnv_tpu_torch.models.samplernn import init_params
    template = {"params": init_params(tt.cfg.model, device="meta")}
    loaded, meta = tckpt.load_checkpoint(path, template, device="cpu")
    assert meta == {"epoch": 1}
    for a, b in zip(jax.tree_util.tree_leaves(loaded["params"]),
                    jax.tree_util.tree_leaves(tt.params)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_errors_match_jax(tmp_path):
    """KeyError for a missing leaf and ValueError for a shape mismatch,
    with the JAX module's messages."""
    tt, jt = _trainers("tiny_unconditional")
    path = str(tmp_path / "params_only.npz")
    tckpt.save_checkpoint(path, {"params": tt.params})
    with pytest.raises(KeyError) as te:
        tckpt.load_checkpoint(path, tt.checkpoint_state())
    with pytest.raises(KeyError) as je:
        jckpt.load_checkpoint(path, jt.checkpoint_state())
    assert "['opt_state'][1][0].count" in str(te.value)
    assert str(te.value) == str(je.value)
    wide, jwide = _trainers("single_speaker_cond")
    with pytest.raises(ValueError) as te:
        tckpt.load_checkpoint(path, {"params": wide.params})
    with pytest.raises(ValueError) as je:
        jckpt.load_checkpoint(path, {"params": jwide.params})
    assert "shape mismatch" in str(te.value)
    assert str(te.value) == str(je.value)


def test_greedy_audio_equal_from_crossed_checkpoints(tmp_path):
    """Weights written by each package and loaded by the other give the
    same greedy (temperature 0) sequences."""
    m = preset("tiny_unconditional").model
    jp, tp = both_params(m, seed=4)
    port_path, jax_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_checkpoint(port_path, {"params": tp})
    jckpt.save_checkpoint(jax_path, {"params": jp})
    in_jax, _ = jckpt.load_checkpoint(port_path, {"params": jp})
    in_port, _ = tckpt.load_checkpoint(jax_path, {"params": tp})
    rng = np.random.RandomState(5)
    cond = rng.rand(2, 4, m.effective_cond_dim).astype(np.float32)
    spk = np.zeros(2, np.int32)
    _, seq_j = jax_generate_fn(in_jax["params"], m, temperature=0.0)(
        jnp.asarray(cond), jnp.asarray(spk), jax.random.PRNGKey(0))
    _, seq_t = generate_fn(in_port["params"], torch_cfg(m),
                           temperature=0.0)(torch.from_numpy(cond),
                                            torch.from_numpy(spk))
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))


def test_manager_retention_and_best_recovery(tmp_path):
    d = str(tmp_path / "ck")
    tt, _ = _trainers("tiny_unconditional")
    mgr = tckpt.CheckpointManager(d)
    assert mgr.latest() is None and mgr.best() is None
    assert mgr.best_loss == float("inf")
    state = tt.checkpoint_state()
    assert mgr.save_epoch(state, 1, 10, val_loss=3.0).endswith("ep1-it10.npz")
    mgr.save_epoch(state, 2, 20, val_loss=4.0)     # not a new best
    mgr.save_epoch(state, 3, 30, val_loss=2.5)
    assert mgr.save_epoch(state, 4, 40, val_loss=9.0,
                          save_last=False) is None
    assert sorted(os.listdir(d)) == ["best-ep3-it30.npz", "ep3-it30.npz"]
    assert mgr.latest()[1:] == (3, 30) and mgr.best()[1:] == (3, 30)
    # a new manager (a resumed run) recovers the best loss from the meta;
    # so does the JAX package's manager, and the other way round
    assert tckpt.CheckpointManager(d).best_loss == 2.5
    jm = jckpt.CheckpointManager(d)
    assert jm.best_loss == 2.5 and jm.latest()[1:] == (3, 30)
    _, meta = jckpt.load_checkpoint(mgr.best()[0], {})
    assert meta == {"epoch": 3, "iteration": 30, "val_loss": 2.5}
    jm.save_epoch({"params": jnp.zeros(2)}, 12, 120, val_loss=1.0)
    again = tckpt.CheckpointManager(d)
    assert again.best_loss == 1.0 and again.latest()[1:] == (12, 120)
    # keep_old retains every last checkpoint
    keep = tckpt.CheckpointManager(str(tmp_path / "keep"), keep_old=True)
    for e in (1, 2, 10):
        keep.save_epoch(state, e, e)
    assert keep.latest()[1:] == (10, 10)
    assert len(os.listdir(str(tmp_path / "keep"))) == 3

