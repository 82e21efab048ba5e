"""The port's fo-pool QRNN (msnv_tpu_torch/ops/qrnn.py) and QRNN-tier models
against the JAX package's, on the CPU in float32.

Tolerances, each with its reason:
  qrnn_apply / qrnn_cell       1e-5   one (B*T, d_in) x (d_in, 3H) product
                                      and an elementwise loop: float32 sums
                                      in another order
  model log-probs              5e-5   the docs/DESIGN.md parity bar
  model gradients              3e-5   the train step's gradient tolerance
                                      (test_torch_train_step.py)
  greedy generation            equal  argmax of logits within 5e-5 of
                                      each other, on untied inputs
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ExperimentConfig, ModelConfig, TrainConfig
from msnv_tpu.models import generate as jgen
from msnv_tpu.models.samplernn import (init_tier_state, predictor_apply,
                                       sequence_nll_loss_bits)
from msnv_tpu.ops import qrnn as jq
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.config import ExperimentConfig as TorchExperimentConfig
from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
from msnv_tpu_torch.interop import params_to_numpy
from msnv_tpu_torch.models import generate as tgen
from msnv_tpu_torch.models import samplernn as tsr
from msnv_tpu_torch.ops import qrnn as tq
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.training import step as tstep
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.plugins import Plugin
from msnv_tpu_torch.training.trainer import Trainer
from msnv_tpu_torch.tree import tree_leaves
from torch_parity import (both_loaders, both_params, flat_numpy,
                          narrow_samplernn, t, torch_cfg)

QRNN = ModelConfig(frame_sizes=(4, 4), n_rnn=2, dim=16, cond_dim=5,
                   spk_dim=3, qrnn=True)


def _layers(n_layers, in_dim=6, hidden=8):
    """JAX QRNN params and the same weights as port tensors."""
    jp = jq.qrnn_init(jax.random.PRNGKey(n_layers), n_layers, in_dim, hidden)
    tp = [{k: t(v) for k, v in layer.items()} for layer in jp]
    return jp, tp


@pytest.mark.parametrize("n_layers", [1, 2])
def test_qrnn_apply_and_cell_match_jax(n_layers):
    jp, tp = _layers(n_layers)
    rng = np.random.RandomState(n_layers)
    x = rng.randn(3, 7, 6).astype(np.float32)
    c0 = rng.randn(n_layers, 3, 8).astype(np.float32)
    yj, cj = jq.qrnn_apply(jp, jnp.asarray(x), jnp.asarray(c0))
    yt, ct = tq.qrnn_apply(tp, t(x), t(c0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    yj, cj = jq.qrnn_cell(jp, jnp.asarray(x[:, 0]), jnp.asarray(c0))
    yt, ct = tq.qrnn_cell(tp, t(x[:, 0]), t(c0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


def test_qrnn_init_layout_and_bounds():
    tp = tq.qrnn_init(torch.Generator().manual_seed(0), 2, 6, 8)
    assert [tuple(layer["w"].shape) for layer in tp] == [(24, 6), (24, 8)]
    assert all(torch.equal(layer["b"], torch.zeros(24)) for layer in tp)
    # lecun_uniform: |w| <= sqrt(3 / fan_in)
    assert float(tp[0]["w"].abs().max()) <= (3.0 / 6) ** 0.5
    assert float(tp[1]["w"].abs().max()) <= (3.0 / 8) ** 0.5


def test_cell_steps_equal_the_sequence():
    _, tp = _layers(2)
    rng = np.random.RandomState(4)
    x = t(rng.randn(2, 5, 6).astype(np.float32))
    c = t(rng.randn(2, 2, 8).astype(np.float32))
    y_seq, c_seq = tq.qrnn_apply(tp, x, c)
    ys = []
    for i in range(x.shape[1]):
        y, c = tq.qrnn_cell(tp, x[:, i], c)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_seq, rtol=0, atol=1e-6)
    torch.testing.assert_close(c, c_seq, rtol=0, atol=1e-6)


def _inputs(cfg, batch=2, n_frames=3, seed=0):
    rng = np.random.RandomState(seed)
    seq_len = n_frames * cfg.lookback
    data = rng.randint(0, cfg.q_levels,
                       (batch, seq_len + cfg.lookback - 1)).astype(np.int32)
    target = rng.randint(0, cfg.q_levels, (batch, seq_len)).astype(np.int32)
    cond = rng.rand(batch, n_frames, cfg.effective_cond_dim).astype(
        np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,)).astype(np.int32)
    return data, target, cond, spk


@pytest.mark.parametrize("which", ["qrnn16", "samplernn32_qrnn"])
def test_qrnn_model_log_probs_and_grads_match_jax(which):
    cfg = {"qrnn16": QRNN, "samplernn32_qrnn": dataclasses.replace(
        narrow_samplernn(), qrnn=True)}[which]
    jp, tp = both_params(cfg)
    assert "w_hh" not in tp["tiers"][0]["gru"][0]
    data, target, cond, spk = _inputs(cfg)
    js = init_tier_state(cfg, 2)

    def jloss(p):
        lp, _, _ = predictor_apply(p, cfg, jnp.asarray(data),
                                   jnp.asarray(True), jnp.asarray(cond),
                                   jnp.asarray(spk), js)
        return sequence_nll_loss_bits(lp, jnp.asarray(target)), lp

    (_, lp_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jp)
    tcfg = torch_cfg(cfg)
    ts = tsr.init_tier_state(tcfg, 2, device="cpu")
    lp_t, _, _ = tsr.predictor_apply(tp, tcfg, t(data), True, t(cond),
                                     t(spk), ts)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=5e-5)
    _, _, g_t = tstep.loss_and_grads(tp, tcfg, ts, t(data), True, t(target),
                                     t(cond), t(spk))
    got, want = params_to_numpy(g_t), flat_numpy(g_j)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=3e-5, err_msg=k)


def test_greedy_generation_equals_jax():
    jp, tp = both_params(QRNN, seed=3)
    rng = np.random.RandomState(3)
    cond = rng.rand(2, 3, QRNN.effective_cond_dim).astype(np.float32)
    spk = np.array([2, 0], np.int32)
    _, seq_j = jgen.generate_fn(jp, QRNN, temperature=0.0)(
        jnp.asarray(cond), jnp.asarray(spk), jax.random.PRNGKey(0))
    _, seq_t = tgen.generate_fn(tp, torch_cfg(QRNN), temperature=0.0)(
        t(cond), t(spk))
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))


def test_qrnn_ignores_gru_impl_and_runs_no_gru_kernel(monkeypatch):
    """gru_impl="pallas" on a QRNN model: the same numbers as "xla", and
    the GRU-layer kernel's wrapper is never reached."""
    from msnv_tpu_torch.ops import gru as tgru

    def refuse(*args, **kwargs):
        raise AssertionError("a QRNN tier reached the GRU-layer kernel")

    monkeypatch.setattr(tgru, "gru_layer", refuse)
    _, tp = both_params(QRNN)
    data, target, cond, spk = _inputs(QRNN)
    out = []
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(torch_cfg(QRNN), gru_impl=impl)
        ts = tsr.init_tier_state(cfg, 2, device="cpu")
        loss, _, grads = tstep.loss_and_grads(
            tp, cfg, ts, t(data), True, t(target), t(cond), t(spk))
        out.append([loss] + tree_leaves(grads))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_qrnn_trainer_matches_jax_trainer_and_resumes(tmp_path):
    """Two epochs of the port's Trainer on a QRNN model against the JAX
    Trainer's (losses and final state to 1e-4, the train step's tolerance),
    and a resume from the epoch-1 checkpoint equal to the straight run."""
    model = dataclasses.replace(QRNN, cond_len=16)
    exp = ExperimentConfig(exp="q", model=model, train=TrainConfig(
        seq_len=2 * model.lookback, batch_size=4, learning_rate=2e-3))
    pexp = TorchExperimentConfig(
        exp="q", model=torch_cfg(model),
        train=TorchTrainConfig(**dataclasses.asdict(exp.train)))
    tl, jl = both_loaders(model, 4, exp.train.seq_len, 4)

    class Capture(Plugin):
        def __init__(self):
            self.losses = []

        def iteration(self, loss):
            self.losses.append(loss)

    jp, _ = both_params(model)
    jt = JaxTrainer(exp, jp, jax_make_optimizer(exp.train, len(jl)), jl)
    jcap = jt.register_plugin(Capture())
    jt.run(2)

    def port(seed=0):
        _, tp = both_params(model, seed)
        return Trainer(pexp, tp, make_optimizer(pexp.train, len(tl)), tl)

    tt = port()
    cap = tt.register_plugin(Capture())
    tt.run(2)
    np.testing.assert_allclose(cap.losses, jcap.losses, rtol=0, atol=1e-4)
    flat, _ = jax.tree_util.tree_flatten_with_path(jt.checkpoint_state())
    want = {"leaf:" + jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    got = tckpt.flatten_state(tt.checkpoint_state())
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    first = port()
    first.run(1)
    path = str(tmp_path / "q.npz")
    tckpt.save_checkpoint(path, first.checkpoint_state(),
                          {"epoch": 1, "iteration": first.iterations})
    resumed = port(seed=3)
    resumed.restore(*tckpt.load_checkpoint(path, resumed.checkpoint_state()))
    rcap = resumed.register_plugin(Capture())
    resumed.run(2)
    assert rcap.losses == cap.losses[len(tl):]
