"""The GAN variant's training in the port (msnv_tpu_torch/training/gan.py,
the Trainer's GAN path) against the JAX package's, on the CPU in float32.

Tolerances, each with its reason:
  lambda_ramp                    bit-equal  float32 arithmetic in the same
                                            order as the JAX package's
  adaptive multiplier            rtol 1e-6  exp of XLA and of torch
  loss, disc_loss, lambda,       1e-4       the train step's tolerance
  params, disc params, moments              (test_torch_train_step.py):
                                            float32 sums in another order,
                                            carried through the updates
  shared vs two-backward grads   1e-5 of the largest gradient: the
                                 discriminator's dgrad chain applied to
                                 -lambda * g_latent instead of to -lambda
                                 (linear, rounded otherwise)
  indexed / block / resume (port only)      bit-equal
The discriminators are 8 channels wide; every comparison with the JAX
package starts both from the same weights, moved across as numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ExperimentConfig, ModelConfig, TrainConfig
from msnv_tpu.models.discriminator import discriminator_init as jax_disc_init
from msnv_tpu.models.samplernn import init_tier_state as jax_init_state
from msnv_tpu.training import checkpoint as jckpt
from msnv_tpu.training.gan import lambda_ramp as jax_lambda_ramp
from msnv_tpu.training.gan import make_gan_train_step as jax_gan_step
from msnv_tpu.training.optim import make_optimizer as jax_make_optimizer
from msnv_tpu.training.trainer import Trainer as JaxTrainer
from msnv_tpu_torch.config import ExperimentConfig as TorchExperimentConfig
from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
from msnv_tpu_torch.interop import (disc_opt_state_from_numpy,
                                    disc_opt_state_to_numpy,
                                    disc_params_from_numpy,
                                    disc_params_to_numpy, params_to_numpy)
from msnv_tpu_torch.models.discriminator import discriminator_init
from msnv_tpu_torch.models.samplernn import init_tier_state
from msnv_tpu_torch.training import checkpoint as tckpt
from msnv_tpu_torch.training import gan as tgan
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.plugins import Plugin
from msnv_tpu_torch.training.trainer import Trainer
from msnv_tpu_torch.tree import tree_leaves, tree_map

from torch_parity import both_loaders, both_params, flat_numpy, t, torch_cfg

ATOL = 1e-4
CH = 8
GAN = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                  cond_len=16, spk_dim=3, variant="gan", ind_cond_dim=6)
TRAIN = dict(seq_len=64, batch_size=4, learning_rate=2e-3,
             lambda_weight=(0.0, 0.5, 4.0), disc_channels=CH)


def _port_train(tc):
    return TorchTrainConfig(**dataclasses.asdict(tc))


def _jax_disc(seed=1, spk_dim=GAN.spk_dim):
    return jax_disc_init(jax.random.PRNGKey(seed), spk_dim, channels=CH)


def _flat(tree, root):
    flat, _ = jax.tree_util.tree_flatten_with_path({root: tree})
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _to_port_disc(jd, spk_dim=GAN.spk_dim):
    return disc_params_from_numpy(_flat(jd, "disc_params"), spk_dim, CH,
                                  device="cpu")


def _batch(cfg, batch=4, seq_len=64, seed=0):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, 256, (batch, seq_len + cfg.lookback - 1))
    target = rng.randint(0, 256, (batch, seq_len))
    cond = rng.rand(batch, seq_len // cfg.lookback, cfg.effective_cond_dim)
    spk = np.arange(batch) % cfg.spk_dim
    return (data.astype(np.int32), target.astype(np.int32),
            cond.astype(np.float32), spk.astype(np.int32))


# --------------------------------------------------------------------------
# lambda: the ramp, the adaptive multiplier, the refused values
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lw,step,want", [
    ((0.0, 0.01, 100.0), 0, 0.0), ((0.0, 0.01, 100.0), 50, 0.005),
    ((0.0, 0.01, 100.0), 100, 0.01), ((0.0, 0.01, 100.0), 100000, 0.01),
    ((0.0, 0.01, 50000.0), 12345, None), ((0.0, 0.01, 50000.0), 49999, None),
    ((0.0, 0.01, 50000.0), 50000, None), ((0.003, 0.01, 0.5), 7, None)])
def test_lambda_ramp_matches_jax(lw, step, want):
    """JAX's table (tests/test_gan.py) and, bit for bit, JAX's float32
    value at the trainer's step (a float32 array)."""
    got = tgan.lambda_ramp(TorchTrainConfig(lambda_weight=lw), step, "cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    ref = np.float32(jax_lambda_ramp(TrainConfig(lambda_weight=lw),
                                     jnp.asarray(float(step), jnp.float32)))
    assert got.numpy() == ref, (float(got), float(ref))
    if want is not None:
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # a 0-d tensor step (the block form's) gives the same value
    assert torch.equal(tgan.lambda_ramp(TorchTrainConfig(lambda_weight=lw),
                                        torch.tensor(float(step))), got)


def test_adaptive_multiplier():
    lam, l2 = torch.tensor(0.01), torch.tensor(0.9)

    def adapt(target, gain, max_mult):
        return tgan.adaptive_lambda(TorchTrainConfig(
            lambda_adaptive=(target, gain, max_mult)), lam, l2)

    assert tgan.adaptive_lambda(TorchTrainConfig(), lam, l2) is lam
    assert torch.equal(adapt(0.5, 0.0, 100.0), lam)          # gain 0: fixed
    for target, gain, max_mult in ((1.2, 2.0, 100.0), (1.2, 1e4, 50.0),
                                   (0.1, 1e4, 50.0), (0.3, 1.5, 4.0)):
        want = jnp.float32(0.01) * jnp.clip(
            jnp.exp(gain * (target - jnp.float32(0.9))), 1.0 / max_mult,
            max_mult)
        np.testing.assert_allclose(float(adapt(target, gain, max_mult)),
                                   float(want), rtol=1e-6)
    np.testing.assert_allclose(float(adapt(1.2, 2.0, 100.0)),
                               0.01 * np.exp(0.6), rtol=1e-6)
    np.testing.assert_allclose(float(adapt(1.2, 1e4, 50.0)), 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(adapt(0.1, 1e4, 50.0)), 0.01 / 50,
                               rtol=1e-6)


@pytest.mark.parametrize("bad", [(0.5, -1.0, 10.0), (0.5, 2.0, 0.5),
                                 (0.5, 2.0, float("nan"))])
def test_lambda_adaptive_refuses_values_that_invert_the_clip(bad):
    """max_mult < 1 crosses the clip's bounds and gain < 0 turns the
    controller around (the JAX package takes both silently); the edges
    gain 0 and max_mult 1 are valid and give the fixed ramp."""
    with pytest.raises(ValueError, match="lambda_adaptive"):
        TorchTrainConfig(lambda_adaptive=bad)
    from msnv_tpu_torch.cli.train import build_parser, config_from_args
    args = build_parser().parse_args(
        ["--exp", "x", "--variant", "gan", "--lambda_adaptive",
         *map(str, bad)])
    with pytest.raises(ValueError, match="lambda_adaptive"):
        config_from_args(args, 3)
    lam = torch.tensor(0.01)
    for edge in ((0.5, 0.0, 3.0), (0.5, 7.0, 1.0)):
        cfg = TorchTrainConfig(lambda_adaptive=edge)
        assert torch.equal(tgan.adaptive_lambda(cfg, lam, torch.tensor(2.)),
                           lam)


# --------------------------------------------------------------------------
# the step against the JAX package's
# --------------------------------------------------------------------------

STEP_CASES = {
    "fixed": (GAN, {}),
    "adaptive_weight_norm": (dataclasses.replace(GAN, weight_norm=True),
                             {"lambda_adaptive": (1.2, 2.0, 10.0)}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_gan_step_matches_jax(case):
    """Five steps from the same weights, lambda ramping over them: loss,
    disc_loss, lambda, params, disc params and both optimizers' moments."""
    model, extra = STEP_CASES[case]
    tc = TrainConfig(**dict(TRAIN, **extra))
    jp, tp = both_params(model)
    jd = _jax_disc()
    td = _to_port_disc(jd)
    jopt, topt = jax_make_optimizer(tc), make_optimizer(_port_train(tc))
    jmo, jdo, tmo, tdo = jopt.init(jp), jopt.init(jd), topt.init(tp), \
        topt.init(td)
    js = jax_init_state(model, 4)
    ts = init_tier_state(torch_cfg(model), 4, device="cpu")
    jstep = jax_gan_step(model, tc, jopt, jopt)
    tstep = tgan.make_gan_train_step(torch_cfg(model), _port_train(tc), topt,
                                     topt)
    data, target, cond, spk = _batch(model)
    for i in range(5):
        jp, jd, jmo, jdo, js, jm = jstep(
            jp, jd, jmo, jdo, js, jnp.asarray(float(i)), jnp.asarray(data),
            jnp.asarray(i == 0), jnp.asarray(target), jnp.asarray(cond),
            jnp.asarray(spk))
        tp, td, tmo, tdo, ts, tm = tstep(tp, td, tmo, tdo, ts, float(i),
                                         t(data), i == 0, t(target),
                                         t(cond), t(spk))
        for name in tgan.METRICS:
            assert tm[name].dtype == torch.float32
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=0, atol=ATOL, err_msg=name)
    assert float(tm["lambda"]) > 0
    got = {**params_to_numpy(tp), **disc_params_to_numpy(td)}
    want = {**flat_numpy(jp), **_flat(jd, "disc_params")}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    tnu = disc_opt_state_to_numpy(tdo)["nu"]
    jnu = _flat(jdo[1][0].nu, "disc_params")
    for k in tnu:
        np.testing.assert_allclose(tnu[k], jnu[k], rtol=0, atol=ATOL,
                                   err_msg=k)


class Recorder:
    """An optimizer that keeps the gradients it is given and moves
    nothing."""

    def init(self, params):
        return {}

    def update(self, grads, opt_state, params):
        self.grads = grads
        return params, opt_state


@pytest.mark.parametrize("adaptive", [None, (1.2, 2.0, 10.0)])
def test_shared_dgrad_equals_the_two_backward_form(adaptive):
    """The step's gradients (one discriminator backward) against
    naive_gan_grads (grad of L1 - lambda L2, then grad of L2), past the
    ramp so that lambda > 0."""
    cfg = torch_cfg(dataclasses.replace(GAN, learn_h0=False))
    tc = _port_train(TrainConfig(**dict(TRAIN, lambda_adaptive=adaptive)))
    _, tp = both_params(GAN)
    td = _to_port_disc(_jax_disc())
    main, disc = Recorder(), Recorder()
    step = tgan.make_gan_train_step(cfg, tc, main, disc)
    data, target, cond, spk = _batch(GAN)
    state = init_tier_state(cfg, 4, device="cpu")
    args = (state, 9.0, t(data), True, t(target), t(cond), t(spk))
    *_, metrics = step(tp, td, {}, {}, *args)
    grads, d_grads, lam = tgan.naive_gan_grads(cfg, tc, tp, td, *args)
    assert float(lam) > 0 and torch.equal(lam, metrics["lambda"])
    for got, want in ((main.grads, grads), (disc.grads, d_grads)):
        scale = max(float(g.abs().max()) for g in tree_leaves(want))
        err = max(float((a - b).abs().max()) for a, b in
                  zip(tree_leaves(got), tree_leaves(want)))
        assert err <= 1e-5 * scale, (err, scale)
    # learn_h0 false: h0 is frozen in both
    assert not main.grads["tiers"][0]["h0"].any()


def test_reversal_changes_the_conditioner_update():
    """The same step at lambda 0 and past the ramp: the conditioner stack's
    first layer moves differently (the reversal reaches it); the tier GRU
    below the latent path moves alike up to the reversal's share."""
    cfg = torch_cfg(GAN)
    tc = _port_train(TrainConfig(**TRAIN))
    data, target, cond, spk = _batch(GAN)
    out = []
    for step_idx in (0.0, 100.0):
        _, tp = both_params(GAN)
        td = _to_port_disc(_jax_disc())
        opt = make_optimizer(tc)
        step = tgan.make_gan_train_step(cfg, tc, opt, opt)
        tp, td, _, _, _, m = step(
            tp, td, opt.init(tp), opt.init(td),
            init_tier_state(cfg, 4, device="cpu"), step_idx, t(data), True,
            t(target), t(cond), t(spk))
        out.append((tp, m))
    (p0, m0), (p1, m1) = out
    assert float(m0["lambda"]) == 0.0 and float(m1["lambda"]) == 0.5
    assert torch.equal(m0["loss"], m1["loss"])
    w0 = p0["tiers"][-1]["conditioner"]["stack"][0]["w"]
    w1 = p1["tiers"][-1]["conditioner"]["stack"][0]["w"]
    assert not torch.equal(w0, w1)
    # the sample MLP is not on the latent's path: the same update
    assert torch.equal(p0["mlp"]["out"]["w"], p1["mlp"]["out"]["w"])


def test_step_refuses_other_variants_and_mesh():
    tc = _port_train(TrainConfig(**TRAIN))
    opt = make_optimizer(tc)
    with pytest.raises(ValueError, match="gan"):
        tgan.make_gan_train_step(torch_cfg(dataclasses.replace(
            GAN, variant="bottleneck")), tc, opt, opt)
    # mesh= takes a parallel.mesh.Mesh (tests/test_torch_parallel.py)
    with pytest.raises(TypeError, match="mesh"):
        tgan.make_gan_train_step(torch_cfg(GAN), tc, opt, opt,
                                 mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        tgan.make_gan_train_block_scan(torch_cfg(GAN), tc, opt, opt, 64, 16,
                                       4, mesh=object())


def test_indexed_and_block_forms_equal_the_tensor_form():
    """Five chunks of one corpus: the tensor step on host slices, the
    indexed step and two blocks (3 + 2, the ramp at step_idx0 + position)
    give the same bits."""
    tc = _port_train(TrainConfig(**TRAIN))
    cfg = torch_cfg(GAN)
    tl, _ = both_loaders(GAN, 4, 64, 5)
    corpus = tl.device_arrays("cpu")
    geo = (tl.seq_len, tl.overlap_len, tl.cond_in_seq)
    runs = []
    for form in ("tensor", "indexed", "block"):
        _, tp = both_params(GAN)
        td = _to_port_disc(_jax_disc())
        opt = make_optimizer(tc)
        mo, do = opt.init(tp), opt.init(td)
        st = init_tier_state(cfg, 4, device="cpu")
        metrics = []
        if form == "block":
            scan = tgan.make_gan_train_block_scan(cfg, tc, opt, opt, *geo)
            for i0, ks in ((0, [0, 1, 2]), (3, [3, 4])):
                tp, td, mo, do, st, m = scan(tp, td, mo, do, st, float(i0),
                                             corpus, ks)
                assert m["loss"].shape == (len(ks),)
                metrics.append(torch.stack([m[n] for n in tgan.METRICS], 1))
        else:
            step = (tgan.make_gan_train_step(cfg, tc, opt, opt)
                    if form == "tensor" else
                    tgan.make_gan_train_step_indexed(cfg, tc, opt, opt,
                                                     *geo))
            for k in range(5):
                if form == "tensor":
                    c = tl.get_chunk(k)
                    args = (t(c.data), c.reset, t(c.target), t(c.cond),
                            t(c.spk))
                else:
                    args = (corpus, k)
                tp, td, mo, do, st, m = step(tp, td, mo, do, st, float(k),
                                             *args)
                metrics.append(torch.stack([m[n] for n in tgan.METRICS])[
                    None])
        runs.append((torch.cat(metrics), tree_leaves(tp) + tree_leaves(td)
                     + st + tree_leaves(do["mu"])))
    for metrics, leaves in runs[1:]:
        assert torch.equal(metrics, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(leaves, runs[0][1]))
    np.testing.assert_allclose(runs[0][0][:, 2].numpy(),
                               [0.0, 0.125, 0.25, 0.375, 0.5], rtol=1e-6)


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------

def _exp(**train):
    return ExperimentConfig(exp="gan", model=GAN,
                            train=TrainConfig(**dict(TRAIN, **train)))


def _port_exp(exp):
    return TorchExperimentConfig(exp=exp.exp, model=torch_cfg(exp.model),
                                 train=_port_train(exp.train))


def _port_trainer(exp, tl, seed=0, jax_disc=True, **kw):
    _, tp = both_params(exp.model, seed)
    pexp = _port_exp(exp)
    tt = Trainer(pexp, tp, make_optimizer(pexp.train, len(tl)), tl, **kw)
    if jax_disc:
        # the JAX Trainer's discriminator: PRNGKey(seed + 1), disc_channels
        tt.disc_params = _to_port_disc(_jax_disc(exp.train.seed + 1))
        tt.disc_opt_state = tt.disc_opt.init(tt.disc_params)
    return tt


def _jax_trainer(exp, jl, seed=0):
    jp, _ = both_params(exp.model, seed)
    return JaxTrainer(exp, jp, jax_make_optimizer(exp.train, len(jl)), jl)


class Capture(Plugin):
    def __init__(self):
        self.losses, self.disc = [], []

    def iteration(self, loss):
        self.losses.append(loss)

    def epoch(self, epoch_index):
        self.disc.append((self.trainer.stats["disc_loss"]["last"],
                          self.trainer.stats["lambda"]["last"]))


def _state_flat(trainer):
    state = trainer.checkpoint_state()
    if isinstance(trainer, Trainer):
        return tckpt.flatten_state(state, trainer.cfg.train.scheduler)
    return _flat_any(state)


def _flat_any(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x)
            for p, x in flat}


@pytest.fixture(scope="module")
def jax_gan_run():
    """Two epochs of the JAX Trainer, GAN variant, device corpus (its
    blocks), with the scheduler on (its optax chain then holds a schedule
    count): (losses, per-epoch (disc_loss, lambda), final state)."""
    exp = _exp(scheduler=True)
    _, jl = both_loaders(GAN, 4, 64, 5)
    jt = _jax_trainer(exp, jl)
    assert jt.is_gan and jt._corpus_dev is not None
    cap = jt.register_plugin(Capture())
    jt.run(2)
    return cap.losses, cap.disc, _state_flat(jt)


@pytest.mark.parametrize("device_corpus", [True, False])
def test_gan_trainer_matches_jax_trainer(device_corpus, jax_gan_run):
    exp = _exp(scheduler=True)
    tl, _ = both_loaders(GAN, 4, 64, 5)
    tt = _port_trainer(exp, tl, device_corpus=device_corpus)
    assert tt.is_gan and (tt._corpus_dev is not None) == device_corpus
    cap = tt.register_plugin(Capture())
    tt.run(2)
    losses, disc, jflat = jax_gan_run
    np.testing.assert_allclose(cap.losses, losses, rtol=0, atol=ATOL)
    np.testing.assert_allclose(cap.disc, disc, rtol=0, atol=ATOL)
    assert cap.disc[-1][1] == pytest.approx(0.5)      # past the ramp
    tflat = _state_flat(tt)
    assert tflat.keys() == jflat.keys()
    assert "leaf:['disc_opt_state'][1][0].count" in tflat
    assert "leaf:['opt_state'][1][1].count" in tflat
    for k in tflat:
        np.testing.assert_allclose(tflat[k], jflat[k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("device_corpus", [True, False])
def test_gan_resume_equals_uninterrupted(device_corpus, tmp_path):
    exp = _exp()
    tl, _ = both_loaders(GAN, 4, 64, 5)
    whole = _port_trainer(exp, tl, jax_disc=False,
                          device_corpus=device_corpus)
    cap_whole = whole.register_plugin(Capture())
    whole.run(2)
    first = _port_trainer(exp, tl, jax_disc=False,
                          device_corpus=device_corpus)
    first.run(1)
    path = tckpt.CheckpointManager(str(tmp_path)).save_epoch(
        first.checkpoint_state(), first.epochs, first.iterations)
    resumed = _port_trainer(exp, tl, seed=5, jax_disc=False,
                            device_corpus=device_corpus)
    state, meta = tckpt.load_checkpoint(path, resumed.checkpoint_state())
    resumed.restore(state, meta)
    cap = resumed.register_plugin(Capture())
    resumed.run(2)
    assert cap.losses == cap_whole.losses[len(tl):]
    assert cap.disc[-1] == cap_whole.disc[-1]
    a, b = _state_flat(whole), _state_flat(resumed)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_trainer_discriminator_init():
    """Seeded with seed + 1 at disc_channels, the same recipe of clipped
    Adam; a restore without discriminator leaves keeps the current one."""
    exp = _exp(seed=3, disc_channels=4)
    tl, _ = both_loaders(GAN, 4, 64, 2)
    tt = _port_trainer(exp, tl, jax_disc=False)
    ref = discriminator_init(torch.Generator().manual_seed(4), GAN.spk_dim, 4,
                             device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tt.disc_params), tree_leaves(ref)))
    assert tt.disc_params["classifier"]["w"].shape == (GAN.spk_dim, 4)
    assert tt.disc_opt is tt.optimizer
    held = tt.disc_params
    st = tt.checkpoint_state()
    del st["disc_params"], st["disc_opt_state"]
    tt.restore(st, {"epoch": 0})
    assert tt.disc_params is held


@pytest.mark.parametrize("exposure", [{"ss_prob": 0.2},
                                      {"input_noise_prob": 0.1}])
def test_gan_with_exposure_raises(exposure):
    exp = _exp(**exposure)
    tl, _ = both_loaders(GAN, 4, 64, 2)
    with pytest.raises(ValueError, match="GAN"):
        _port_trainer(exp, tl, jax_disc=False)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_gan_checkpoints_cross_load_with_the_jax_trainer(direction, tmp_path,
                                                        jax_gan_run):
    """Epoch 1 in one package, saved, resumed by the other's Trainer for
    epoch 2: the JAX run's epoch-2 losses (scheduler on: the optax schedule
    count crosses too)."""
    exp = _exp(scheduler=True)
    tl, jl = both_loaders(GAN, 4, 64, 5)
    path = str(tmp_path / "gan.npz")
    if direction == "jax_to_port":
        first = _jax_trainer(exp, jl)
        first.run(1)
        jckpt.save_checkpoint(path, first.checkpoint_state(),
                              {"epoch": 1, "iteration": first.iterations})
        second = _port_trainer(exp, tl, seed=4, jax_disc=False)
        state, meta = tckpt.load_checkpoint(path, second.checkpoint_state())
    else:
        first = _port_trainer(exp, tl)
        first.run(1)
        tckpt.save_checkpoint(path, first.checkpoint_state(),
                              {"epoch": 1, "iteration": first.iterations},
                              scheduled=exp.train.scheduler)
        second = _jax_trainer(exp, jl, seed=4)
        state, meta = jckpt.load_checkpoint(path, second.checkpoint_state())
    second.restore(state, meta)
    cap = second.register_plugin(Capture())
    second.run(2)
    losses, disc, _ = jax_gan_run
    np.testing.assert_allclose(cap.losses, losses[len(tl):], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(cap.disc[-1], disc[-1], rtol=0, atol=ATOL)


def test_schedule_count_in_checkpoints(tmp_path):
    """With the scheduler a checkpoint carries the optax schedule's count
    under ['opt_state'][1][1].count (and the discriminator's under
    ['disc_opt_state'][1][1].count), written from the Adam count; without
    it, none. Loading ignores the entry."""
    opt = make_optimizer(_port_train(TrainConfig(**dict(TRAIN,
                                                        scheduler=True))))
    _, tp = both_params(GAN)
    st = opt.init(tp)
    tp, st = opt.update(tree_map(torch.ones_like, tp), st, tp)
    assert set(st) == {"count", "mu", "nu"} and st["count"] == 1
    state = {"opt_state": st, "disc_opt_state": st}
    flat = tckpt.flatten_state(state, scheduled=True)
    for root in ("opt_state", "disc_opt_state"):
        assert flat[f"leaf:['{root}'][1][1].count"] == 1
        assert flat[f"leaf:['{root}'][1][0].count"] == 1
    assert not any("[1][1]" in k for k in tckpt.flatten_state(state))
    path = str(tmp_path / "scheduled.npz")
    st["count"] = 7
    tckpt.save_checkpoint(path, state, scheduled=True)
    loaded, _ = tckpt.load_checkpoint(path, state)
    assert loaded["opt_state"]["count"] == 7
    assert set(loaded["opt_state"]) == {"count", "mu", "nu"}
    with np.load(path) as z:
        assert int(z["leaf:['disc_opt_state'][1][1].count"]) == 7


def test_disc_opt_state_numpy_round_trip():
    td = _to_port_disc(_jax_disc())
    opt = make_optimizer(_port_train(TrainConfig(**TRAIN)))
    st = opt.init(td)
    td, st = opt.update(tree_map(torch.ones_like, td), st, td)
    flat = disc_opt_state_to_numpy(st)
    assert flat["count"] == 1
    assert set(flat["mu"]) == set(disc_params_to_numpy(td))
    back = disc_opt_state_from_numpy(flat, GAN.spk_dim, CH, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back["nu"]), tree_leaves(st["nu"])))


# --------------------------------------------------------------------------
# the train CLI, and evaluate / generate on what it wrote
# --------------------------------------------------------------------------

def _cli_args(data_dir, results, epochs, variant, *extra):
    return ["--exp", "vartest", "--frame_sizes", "4", "4", "--n_rnn", "1",
            "--dim", "32", "--seq_len", "64", "--batch_size", "4",
            "--cond_len", "16", "--norm_ind", "false",
            "--variant", variant, "--ind_cond_dim", "6",
            "--disc_channels", str(CH), "--lambda_weight", "0", "0.5", "4",
            "--datasets_path", data_dir, "--results_path", results,
            "--epoch_limit", str(epochs), "--learning_rate", "2e-3", *extra]


def _call(main, argv):
    """Run a CLI main; restore sys.stdout (the train CLIs tee it)."""
    import sys
    stdout = sys.stdout
    try:
        main(argv)
    finally:
        sys.stdout = stdout


def _exp_dir(results):
    import os
    (tag,) = os.listdir(results)
    return os.path.join(results, tag)


def _stats(results):
    import json
    import os
    with open(os.path.join(_exp_dir(results), "stats.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    from msnv_tpu_torch.data.synthetic import make_synthetic_corpus
    root = tmp_path_factory.mktemp("variants_cli")
    data_dir = str(root / "datasets")
    make_synthetic_corpus(data_dir, n_speakers=2, utts_per_speaker=2,
                          frames_per_utt=150, cond_len=16,
                          partitions=("train", "validation"))
    return root, data_dir


def test_train_cli_bottleneck_matches_jax(corpus_dir):
    """Both train CLIs from one JAX-written warm start, two epochs each,
    with the scheduler: stats.json and the last checkpoint (the schedule's
    count among its keys) agree to 1e-4."""
    import os
    from msnv_tpu.cli.train import main as jax_train
    from msnv_tpu.models.samplernn import init_params as jax_init_params
    from msnv_tpu_torch.cli.train import main as port_train
    root, data_dir = corpus_dir
    model = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=32, cond_dim=43,
                        cond_len=16, spk_dim=2, variant="bottleneck",
                        ind_cond_dim=6)
    warm = str(root / "warm_bottleneck.npz")
    jckpt.save_checkpoint(warm, {"params": jax_init_params(
        jax.random.PRNGKey(1), model)})
    runs = {name: str(root / f"bottleneck_{name}") for name in ("jax", "port")}
    sched = ("--scheduler", "true")
    _call(jax_train, _cli_args(data_dir, runs["jax"], 2, "bottleneck",
                               "--model", warm, *sched))
    _call(port_train, _cli_args(data_dir, runs["port"], 2, "bottleneck",
                                "--model", warm, "--device", "cpu", *sched))
    sp, sj = _stats(runs["port"]), _stats(runs["jax"])
    assert sp.keys() == sj.keys() and "disc_loss" not in sp
    for field in ("training_loss", "validation_loss"):
        np.testing.assert_allclose(sp[field], sj[field], rtol=0, atol=ATOL,
                                   err_msg=field)
    ck = sorted(c for c in os.listdir(os.path.join(_exp_dir(runs["port"]),
                                                   "checkpoints"))
                if c.startswith("ep"))[-1]
    with np.load(os.path.join(_exp_dir(runs["port"]), "checkpoints", ck)) \
            as a, np.load(os.path.join(_exp_dir(runs["jax"]), "checkpoints",
                                       ck)) as b:
        assert set(a.files) == set(b.files)
        assert "leaf:['params']['tiers'][1]['conditioner']['stack'][3]['w']" \
            in a.files
        assert "leaf:['opt_state'][1][1].count" in a.files
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL,
                                           err_msg=k)


def test_train_cli_gan_resumes_evaluates_and_generates(corpus_dir, capsys,
                                                       tmp_path):
    """`--variant gan`: one epoch, then resumed to two; disc_loss and
    lambda in stats.json, the discriminator and its Adam state in the
    checkpoint under the JAX keys; the evaluate CLI reads the trainer's
    validation loss back, and greedy generation writes the WAVs the JAX
    generate CLI writes from the same checkpoint."""
    import filecmp
    import json
    import os
    from msnv_tpu.cli.generate import main as jax_gen
    from msnv_tpu_torch.cli.evaluate import main as port_eval
    from msnv_tpu_torch.cli.generate import main as port_gen
    from msnv_tpu_torch.cli.train import main as port_train
    root, data_dir = corpus_dir
    results = str(root / "gan_port")
    _call(port_train, _cli_args(data_dir, results, 1, "gan", "--device",
                                "cpu"))
    capsys.readouterr()
    _call(port_train, _cli_args(data_dir, results, 2, "gan", "--device",
                                "cpu"))
    out = capsys.readouterr().out
    assert "resumed from" in out and "disc_loss: " in out
    stats = _stats(results)                   # the resumed run's
    assert stats["epochs"] == [2]
    assert len(stats["disc_loss"]) == len(stats["lambda"]) == 1
    assert all(np.isfinite(stats["disc_loss"])) and stats["lambda"][-1] > 0
    ckpt_dir = os.path.join(_exp_dir(results), "checkpoints")
    last = os.path.join(ckpt_dir, sorted(
        c for c in os.listdir(ckpt_dir) if c.startswith("ep"))[-1])
    with np.load(last) as z:
        keys = set(z.files)
    for key in ("leaf:['disc_params']['blocks'][3]['conv2']['w']",
                "leaf:['disc_params']['classifier']['b']",
                "leaf:['disc_opt_state'][1][0].count",
                "leaf:['disc_opt_state'][1][0].nu['blocks'][0]['conv1']"
                "['w']"):
        assert key in keys, key
    port_eval(["--model", last, "--datasets_path", data_dir,
               "--partitions", "validation", "--device", "cpu"])
    nll = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "validation"]["nll_bits"]
    assert abs(nll - stats["validation_loss"][-1]) <= ATOL
    names = sorted(os.path.splitext(f)[0] for f in
                   os.listdir(os.path.join(data_dir, "wav")))[:2]
    cond_list, spk_list = str(tmp_path / "c.list"), str(tmp_path / "s.list")
    with open(cond_list, "w") as f:
        f.write("\n".join(names))
    with open(spk_list, "w") as f:
        f.write("0\n1\n")
    common = ["--model", last, "--cond_path", os.path.join(data_dir, "cond"),
              "--cond_list", cond_list, "--spk_list", spk_list,
              "--min_max", os.path.join(data_dir, "npy_datasets",
                                        "min_max_joint.npy"),
              "--temperature", "0"]
    jax_gen(common + ["--out_dir", str(tmp_path / "j")])
    port_gen(common + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    wavs = sorted(os.listdir(tmp_path / "j"))
    assert wavs == sorted(os.listdir(tmp_path / "t")) and len(wavs) == 2
    for w in wavs:
        assert filecmp.cmp(tmp_path / "j" / w, tmp_path / "t" / w,
                           shallow=False), w
