"""The port's training loop against the JAX package's, on the CPU: the
device-corpus blocks, the Trainer over two epochs from identical weights,
exact resume, and the generation plugins.

Inputs come from a numpy seed (tests/torch_parity.corpus_arrays) and go
through both packages in float32. Tolerances, each with its reason:
  iteration / validation loss  1e-4 bits  the train step's tolerance of
                                          test_torch_train_step.py: float32
                                          sums in another order (XLA's CPU
                                          dots vs torch's), carried through
                                          the updates of two epochs
  params, Adam mu/nu           1e-4       the same (Adam divides by
                                          sqrt(nu) ~ |g|: a gradient's
                                          rounding error moves an update by
                                          (error / |g|) * lr)
  blocks vs indexed steps, resume vs uninterrupted (port only): bit-equal.
JAX's PRNG and torch's differ, so every cross-package comparison runs with
exposure off; the port's exposure stream is held to itself.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from msnv_tpu.config import ExperimentConfig, ModelConfig, TrainConfig
from msnv_tpu.training import checkpoint as jckpt
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.plugins import ValidationPlugin as JaxValidation
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.config import ExperimentConfig as TorchExperimentConfig
from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
from msnv_tpu_torch.data.wavio import read_wav, wav_bytes
from msnv_tpu_torch.models.generate import generate_fn
from msnv_tpu_torch.models.samplernn import init_tier_state
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.training import step as tstep
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.plugins import (GeneratorPlugin,
                                             ObjectiveMetricsPlugin, Plugin,
                                             SaverPlugin, ValidationPlugin)
from msnv_tpu_torch.training.trainer import Trainer
from msnv_tpu_torch.tree import tree_leaves, tree_map

from torch_parity import (both_loaders, both_params, narrow_samplernn, tiny,
                          torch_cfg)

LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-4
MODELS = {"tiny": tiny, "samplernn32": narrow_samplernn}
EXPOSURE = dict(ss_prob=0.3, input_noise_prob=0.2, input_noise_levels=3)


def _exp(model, **train):
    kw = dict(seq_len=4 * model.lookback, batch_size=4, learning_rate=2e-3)
    kw.update(train)
    return ExperimentConfig(exp="t", model=model, train=TrainConfig(**kw))


def _port_exp(exp):
    return TorchExperimentConfig(
        exp=exp.exp, model=torch_cfg(exp.model),
        train=TorchTrainConfig(**dataclasses.asdict(exp.train)))


def _loaders(exp, n_chunks=5, seed=0):
    return both_loaders(exp.model, exp.train.batch_size, exp.train.seq_len,
                        n_chunks, seed)


def _port_trainer(exp, tl, seed=0, **kw):
    _, tp = both_params(exp.model, seed)
    pexp = _port_exp(exp)
    return Trainer(pexp, tp, make_optimizer(pexp.train, len(tl)), tl, **kw)


class Capture(Plugin):
    """Every iteration loss, and the validation loss of every epoch."""

    def __init__(self):
        self.losses, self.val = [], []

    def iteration(self, loss):
        self.losses.append(loss)

    def epoch(self, epoch_index):
        self.val.append(self.trainer.stats.get("validation_loss",
                                               {}).get("last"))


def _flat(trainer):
    state = trainer.checkpoint_state()
    if isinstance(trainer, Trainer):
        return tckpt.flatten_state(state)
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


# --------------------------------------------------------------------------
# the blocks against the indexed steps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("exposure", [False, True])
def test_train_block_equals_indexed_steps(exposure):
    exp = _exp(tiny(), **(EXPOSURE if exposure else {}))
    tl, _ = _loaders(exp)
    cfg = torch_cfg(exp.model)
    corpus = tl.device_arrays("cpu")
    geo = (tl.seq_len, tl.overlap_len, tl.cond_in_seq)
    expo = tstep.exposure_tuple(exp.train)
    key = (11, 3) if exposure else ()
    runs = []
    for blocked in (False, True):
        _, params = both_params(exp.model)
        opt = make_optimizer(_port_exp(exp).train)
        opt_state = opt.init(params)
        state = init_tier_state(cfg, 4, device="cpu")
        if blocked:
            scan = tstep.make_train_block_scan(cfg, opt, *geo, exposure=expo)
            losses = []
            for ks in ([0, 1, 2], [3, 4]):
                params, opt_state, state, blk = scan(params, opt_state,
                                                     state, corpus, ks, key)
                assert blk.shape == (len(ks),)
                losses += list(blk)
        else:
            step = tstep.make_train_step_indexed(cfg, opt, *geo,
                                                 exposure=expo)
            losses = []
            for k in range(5):
                extra = ((tstep.fold_generator("cpu", *key, k),)
                         if exposure else ())
                params, opt_state, state, loss = step(
                    params, opt_state, state, corpus, k, *extra)
                losses.append(loss)
        runs.append((torch.stack(losses), tree_leaves(params) + state,
                     tree_leaves(opt_state["mu"])))
    (l0, p0, m0), (l1, p1, m1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0 + m0, p1 + m1))


def test_eval_block_and_eval_device_corpus_equal_indexed_steps():
    exp = _exp(narrow_samplernn())
    tl, _ = _loaders(exp)
    cfg = torch_cfg(exp.model)
    _, params = both_params(exp.model)
    corpus = tl.device_arrays("cpu")
    geo = (tl.seq_len, tl.overlap_len, tl.cond_in_seq)
    step = tstep.make_eval_step_indexed(cfg, *geo)
    state = init_tier_state(cfg, 4, device="cpu")
    want = []
    for k in range(len(tl)):
        loss, state = step(params, state, corpus, k)
        want.append(loss)
    want = torch.stack(want)
    scan = tstep.make_eval_block_scan(cfg, *geo)
    st = init_tier_state(cfg, 4, device="cpu")
    a, st = scan(params, st, corpus, [0, 1])
    b, st = scan(params, st, corpus, [2, 3, 4])
    assert torch.equal(torch.cat([a, b]), want)
    assert all(torch.equal(x, y) for x, y in zip(st, state))
    for block in (2, 16):
        nll, st = tstep.eval_device_corpus(
            cfg, params, init_tier_state(cfg, 4, device="cpu"), tl,
            scan_block=block)
        assert nll == float(want.mean())
        assert all(torch.equal(x, y) for x, y in zip(st, state))


def test_mesh_raises_for_the_blocks():
    """The blocks take a parallel.mesh.Mesh (tests/test_torch_parallel.py)
    and refuse anything else."""
    cfg = torch_cfg(tiny())
    opt = make_optimizer(TorchTrainConfig())
    with pytest.raises(TypeError, match="mesh"):
        tstep.make_train_block_scan(cfg, opt, 32, 16, 2, mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        tstep.make_eval_block_scan(cfg, 32, 16, 2, mesh=object())


# --------------------------------------------------------------------------
# two epochs against the JAX Trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs():
    """Two epochs of the JAX Trainer (device corpus, the default) per
    model, with validation: (losses, validation losses, final state)."""
    out = {}
    for name, model in MODELS.items():
        exp = _exp(model())
        _, jl = _loaders(exp)
        _, jv = _loaders(exp, n_chunks=3, seed=9)
        jp, _ = both_params(exp.model)
        jt = JaxTrainer(exp, jp, jax_make_optimizer(exp.train, len(jl)), jl)
        assert jt._corpus_dev is not None
        jt.register_plugin(JaxValidation(jv, jv))
        cap = jt.register_plugin(Capture())
        jt.run(2)
        out[name] = (cap.losses, cap.val, _flat(jt))
    return out


@pytest.mark.parametrize("device_corpus", [True, False])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_two_epochs_match_jax_trainer(name, device_corpus, jax_runs):
    exp = _exp(MODELS[name]())
    tl, _ = _loaders(exp)
    tv, _ = _loaders(exp, n_chunks=3, seed=9)
    tt = _port_trainer(exp, tl, device_corpus=device_corpus)
    assert (tt._corpus_dev is not None) == device_corpus
    tt.register_plugin(ValidationPlugin(tv, tv))
    cap = tt.register_plugin(Capture())
    tt.run(2)
    losses, val, jflat = jax_runs[name]
    assert len(cap.losses) == len(losses) == 2 * len(tl)
    np.testing.assert_allclose(cap.losses, losses, rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(cap.val, val, rtol=0, atol=LOSS_ATOL)
    assert cap.losses[-1] < cap.losses[0]
    tflat = _flat(tt)
    assert tflat.keys() == jflat.keys()
    for k in tflat:
        np.testing.assert_allclose(tflat[k], jflat[k], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    assert tt.iterations == 2 * len(tl) and tt.epochs == 2


def test_jax_checkpoint_resumed_by_the_port(tmp_path, jax_runs):
    """A JAX run saved after epoch 1 and resumed by the port continues the
    JAX run's epoch-2 losses."""
    exp = _exp(tiny())
    tl, jl = _loaders(exp)
    jp, _ = both_params(exp.model)
    jt = JaxTrainer(exp, jp, jax_make_optimizer(exp.train, len(jl)), jl)
    jt.run(1)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jt.checkpoint_state(),
                          {"epoch": jt.epochs, "iteration": jt.iterations})
    tt = _port_trainer(exp, tl, seed=3)
    state, meta = tckpt.load_checkpoint(path, tt.checkpoint_state())
    tt.restore(state, meta)
    cap = tt.register_plugin(Capture())
    tt.run(2)
    want = jax_runs["tiny"][0][len(tl):]
    np.testing.assert_allclose(cap.losses, want, rtol=0, atol=LOSS_ATOL)


# --------------------------------------------------------------------------
# resume, in-place updates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["epoch", "mid_epoch"])
@pytest.mark.parametrize("device_corpus", [True, False])
def test_resume_equals_uninterrupted(where, device_corpus, tmp_path):
    """With exposure on, bit-exact: a resumed run replays the same losses,
    params, moments and hidden state as the uninterrupted one."""
    exp = _exp(tiny(), **EXPOSURE)
    tl, _ = _loaders(exp)
    whole = _port_trainer(exp, tl, device_corpus=device_corpus)
    cap_whole = whole.register_plugin(Capture())
    whole.run(2)

    first = _port_trainer(exp, tl, device_corpus=device_corpus)
    manager = tckpt.CheckpointManager(str(tmp_path), keep_old=True)
    if where == "epoch":
        first.run(1)
        path = manager.save_epoch(first.checkpoint_state(), first.epochs,
                                  first.iterations, meta={"tag": "t"})
    else:
        # interval saves snapshot the state as of their iteration
        first.register_plugin(SaverPlugin(manager, every_n_iterations=2))
        first.run(1)
        path = os.path.join(str(tmp_path), "ep0-it2.npz")
    resumed = _port_trainer(exp, tl, seed=5, device_corpus=device_corpus)
    state, meta = tckpt.load_checkpoint(path, resumed.checkpoint_state())
    resumed.restore(state, meta)
    assert resumed.start_chunk == (0 if where == "epoch" else 2)
    cap = resumed.register_plugin(Capture())
    resumed.run(2)
    assert cap.losses == cap_whole.losses[resumed.iterations
                                          - len(cap.losses):]
    a, b = _flat(whole), _flat(resumed)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_checkpoint_state_is_a_snapshot_and_restore_feeds_the_steps():
    exp = _exp(tiny())
    tl, _ = _loaders(exp)
    tt = _port_trainer(exp, tl)
    held = tt.checkpoint_state()
    before = tree_map(lambda x: x if isinstance(x, int) else x.clone(), held)
    tt.train_chunk(tl.get_chunk(0))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(held["params"]), tree_leaves(before["params"])))
    assert held["opt_state"]["count"] == 0
    assert not torch.equal(tree_leaves(tt.params)[0],
                           tree_leaves(held["params"])[0])
    # restore: the steps train the loaded tensors, in place
    tt.restore(held, {"epoch": 0, "iteration": 0})
    tt.train_chunk(tl.get_chunk(0))
    assert tt.params is held["params"]
    assert held["opt_state"]["count"] == 1
    assert not torch.equal(tree_leaves(held["params"])[0],
                           tree_leaves(before["params"])[0])


def test_trainer_unported_paths_raise():
    """mesh= takes a parallel.mesh.Mesh (tests/test_torch_parallel.py) and
    refuses anything else; the GAN variant trains, but not with
    exposure-bias mitigation, which the JAX Trainer refuses too."""
    exp = _exp(tiny())
    tl, _ = _loaders(exp)
    with pytest.raises(TypeError, match="mesh"):
        _port_trainer(exp, tl, mesh=object())
    gan = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, variant="gan"), train=dataclasses.replace(
        exp.train, ss_prob=0.1))
    _, tp = both_params(exp.model)
    with pytest.raises(ValueError, match="GAN"):
        Trainer(_port_exp(gan), tp, make_optimizer(TorchTrainConfig()), tl)


# --------------------------------------------------------------------------
# generation inside plugins
# --------------------------------------------------------------------------

class Snapshot(Plugin):
    """The params as of every epoch's end, and the MCD the metrics plugin
    (registered before this one) scored."""

    def __init__(self):
        self.params, self.mcd = {}, {}

    def epoch(self, epoch_index):
        self.params[epoch_index] = self.trainer.checkpoint_state()["params"]
        self.mcd[epoch_index] = self.trainer.stats["mcd_db"]["last"]


def test_generation_plugins_use_the_current_weights(tmp_path):
    """GeneratorPlugin and ObjectiveMetricsPlugin sample from the weights
    of the epoch they score, not from those their generator first saw."""
    from msnv_tpu_torch.eval.metrics import evaluate_pair
    exp = _exp(ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, cond_dim=3,
                           spk_dim=2, cond_len=16))
    tl, _ = _loaders(exp)
    tt = _port_trainer(exp, tl)
    rng = np.random.RandomState(8)
    frames = 40
    cond = rng.rand(2, frames, 3).astype(np.float32)
    spk = np.array([0, 1], np.int32)
    ref = (0.3 * rng.randn(2, frames * 16)).astype(np.float32)
    tt.register_plugin(GeneratorPlugin(str(tmp_path), cond, spk))
    tt.register_plugin(ObjectiveMetricsPlugin(cond, spk, ref, hop=16))
    snap = tt.register_plugin(Snapshot())
    tt.run(2)
    cfg = tt.cfg.model

    def audio(params, epoch):
        out, _ = generate_fn(params, cfg)(
            torch.from_numpy(cond), torch.from_numpy(spk),
            torch.Generator().manual_seed(epoch))
        return out.numpy()

    for epoch in (1, 2):
        want = audio(snap.params[epoch], epoch)
        for i in range(2):
            got, _ = read_wav(str(tmp_path / f"ep{epoch}-s{spk[i]}-{i}.wav"))
            np.testing.assert_array_equal(
                got, np.frombuffer(wav_bytes(want[i], 16000)[44:], "<i2")
                / 32768.0)
        mcd = np.mean([evaluate_pair(ref[i], want[i], hop=16)["mcd_db"]
                       for i in range(2)])
        assert snap.mcd[epoch] == pytest.approx(mcd, rel=1e-12)
    # the epoch-1 weights would have given other audio at epoch 2
    stale = audio(snap.params[1], 2)
    assert not np.array_equal(stale, audio(snap.params[2], 2))
