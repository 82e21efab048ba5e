"""The port's train slice against the JAX package's, on the CPU: the
optimizer, make_train_step / make_eval_step over five TBPTT chunks from
identical weights, the indexed steps and the exposure perturbation.

Inputs come from a numpy seed and go through both packages in float32.
Tolerances, each with its reason:
  loss per step       1e-4 bits  float32 sums in another order (XLA's CPU
                                 dots vs torch's), through five updates
  gradient leaves     3e-5       the same, one backward pass
  params, Adam mu/nu  1e-4       Adam divides by sqrt(nu) ~ |g| in the first
                                 steps, so a gradient's rounding error moves
                                 the update by (error / |g|) * lr however
                                 small g is; lr is 1e-3 here
  carried state       1e-4       follows the params
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import TrainConfig
from msnv_tpu.models.samplernn import init_tier_state as jax_init_state
from msnv_tpu.models.samplernn import predictor_apply as jax_predictor
from msnv_tpu.ops.xent import nll_bits_from_logits as jax_nll
from msnv_tpu.training import optim as joptim
from msnv_tpu.training import step as jstep
from msnv_tpu_torch.config import TrainConfig as TorchTrainConfig
from msnv_tpu_torch.interop import (opt_state_from_numpy,
                                    opt_state_to_numpy, params_to_numpy)
from msnv_tpu_torch.models.samplernn import init_tier_state
from msnv_tpu_torch.training import optim as toptim
from msnv_tpu_torch.training import step as tstep
from msnv_tpu_torch.tree import tree_leaves, tree_map

from torch_parity import (both_params, flat_numpy, narrow_samplernn, t, tiny,
                          torch_cfg)

LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-4, 3e-5, 1e-4
N_STEPS = 5
TRAIN = dict(learning_rate=1e-3, grad_clip=1.0)


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_grad_clip_semantics():
    """Element-wise clip to [-1, 1] before Adam: the first update of a
    clipped Adam is -lr * sign(g) whatever |g|, and equals optax's."""
    tc = dict(learning_rate=1.0, grad_clip=1.0)
    g = np.array([-5.0, 0.5, 7.0, 0.0], np.float32)
    jopt = joptim.make_optimizer(TrainConfig(**tc))
    jp = {"w": jnp.zeros(4)}
    updates, _ = jopt.update({"w": jnp.asarray(g)}, jopt.init(jp), jp)
    topt = toptim.make_optimizer(TorchTrainConfig(**tc))
    tp = {"w": torch.zeros(4)}
    tp, st = topt.update({"w": t(g)}, topt.init(tp), tp)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(updates["w"]),
                               atol=1e-6)
    np.testing.assert_array_equal(np.sign(tp["w"].numpy()), [1, -1, -1, 0])
    # the second moment saw the CLIPPED gradient
    np.testing.assert_allclose(st["nu"]["w"].numpy(),
                               0.001 * np.clip(g, -1, 1) ** 2, atol=1e-9)


@pytest.mark.parametrize("scheduler", [False, True])
def test_adam_trajectory_matches_optax(scheduler):
    """Ten updates with changing gradients, across a schedule boundary."""
    tc = dict(learning_rate=1e-2, grad_clip=0.5, scheduler=scheduler,
              scheduler_milestones=(2, 4), scheduler_gamma=0.1)
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": [rng.randn(5).astype(np.float32)]}
    jopt = joptim.make_optimizer(TrainConfig(**tc), steps_per_epoch=2)
    topt = toptim.make_optimizer(TorchTrainConfig(**tc), steps_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(lambda x: t(x).clone(), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    import optax
    for _ in range(10):
        g = {"a": rng.randn(3, 4).astype(np.float32),
             "b": [rng.randn(5).astype(np.float32)]}
        upd, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update(tree_map(t, g), ts, tp)
        np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]),
                                   atol=1e-6)
        np.testing.assert_allclose(tp["b"][0].numpy(),
                                   np.asarray(jp["b"][0]), atol=1e-6)
    assert ts["count"] == 10


def test_lr_schedule_multistep():
    """Equal to optax's piecewise-constant schedule at every count,
    including the step AT each boundary (count == milestone * steps)."""
    tc = dict(learning_rate=1e-3, scheduler=True,
              scheduler_milestones=(2, 4), scheduler_gamma=0.1)
    jsched = joptim.lr_schedule(TrainConfig(**tc), steps_per_epoch=10)
    tsched = toptim.lr_schedule(TorchTrainConfig(**tc), steps_per_epoch=10)
    for count in (0, 19, 20, 21, 39, 40, 41, 1000):
        assert np.isclose(tsched(count), float(jsched(count)), rtol=1e-6)
    assert np.isclose(tsched(19), 1e-3) and np.isclose(tsched(20), 1e-4)
    assert np.isclose(tsched(40), 1e-5)
    flat = toptim.lr_schedule(TorchTrainConfig(learning_rate=3e-4), 10)
    assert flat(0) == flat(10 ** 6) == 3e-4


def test_opt_state_numpy_round_trip():
    cfg = torch_cfg(tiny())
    _, tp = both_params(tiny())
    opt = toptim.make_optimizer(TorchTrainConfig(**TRAIN))
    st = opt.init(tp)
    grads = tree_map(torch.ones_like, tp)
    tp, st = opt.update(grads, st, tp)
    flat = opt_state_to_numpy(st)
    assert flat["count"] == 1
    assert set(flat["mu"]) == set(params_to_numpy(tp))
    back = opt_state_from_numpy(flat, cfg, device="cpu")
    for a, b in zip(tree_leaves(back["nu"]),
                    tree_leaves(st["nu"])):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def _chunks(cfg, batch, seq_len, n, seed=0):
    """n consecutive TBPTT chunks cut from one random stream per lane."""
    rng = np.random.RandomState(seed)
    lb = cfg.lookback
    stream = rng.randint(0, cfg.q_levels, (batch, n * seq_len + lb))
    cond = rng.rand(batch, n * seq_len // lb,
                    cfg.effective_cond_dim).astype(np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,)).astype(np.int32)
    out = []
    for k in range(n):
        s = k * seq_len
        out.append((stream[:, s:s + seq_len + lb - 1].astype(np.int32),
                    stream[:, s + lb:s + lb + seq_len].astype(np.int32),
                    cond[:, k * seq_len // lb:(k + 1) * seq_len // lb], spk))
    return out


def _jax_run(cfg, jp, chunks, batch):
    opt = joptim.make_optimizer(TrainConfig(**TRAIN))
    step = jstep.make_train_step(cfg, opt, donate=False)

    def loss_fn(params, state, data, cond, spk, target):
        logits, _, _ = jax_predictor(params, cfg, data, jnp.asarray(True),
                                     cond, spk, state, output="logits")
        return jax_nll(logits, target)

    data, target, cond, spk = chunks[0]
    state = jax_init_state(cfg, batch)
    grads = jstep.freeze_h0_grads(cfg, jax.jit(jax.grad(loss_fn))(
        jp, state, data, cond, spk, target))
    p, o, losses = jp, opt.init(jp), []
    for i, (data, target, cond, spk) in enumerate(chunks):
        p, o, state, loss = step(p, o, state, data, jnp.asarray(i == 0),
                                 target, cond, spk)
        losses.append(float(loss))
    adam = o[1][0]
    return losses, grads, p, adam, state


def _torch_inputs(chunk):
    data, target, cond, spk = chunk
    return t(data), t(target), t(cond), t(spk, torch.int64)


def _torch_run(cfg, tp, chunks, batch, compute_dtype=None):
    c = torch_cfg(cfg)
    opt = toptim.make_optimizer(TorchTrainConfig(**TRAIN))
    step = tstep.make_train_step(c, opt, compute_dtype=compute_dtype)
    data, target, cond, spk = _torch_inputs(chunks[0])
    state = init_tier_state(c, batch, device="cpu")
    _, _, grads = tstep.loss_and_grads(tp, c, state, data, True, target,
                                       cond, spk, compute_dtype)
    o, losses = opt.init(tp), []
    for i, chunk in enumerate(chunks):
        data, target, cond, spk = _torch_inputs(chunk)
        tp, o, state, loss = step(tp, o, state, data, i == 0, target, cond,
                                  spk)
        losses.append(float(loss))
    return losses, grads, tp, o, state


def _assert_tree_close(torch_tree, jax_tree, atol, what):
    got = params_to_numpy(torch_tree)
    want = flat_numpy(jax_tree)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   err_msg=f"{what} {key}")


def _cases():
    cases = {}
    for name, make, batch, seq_len in (("tiny", tiny, 4, 32),
                                       ("samplernn32", narrow_samplernn, 3,
                                        160)):
        for impl in ("xla", "pallas"):
            for learn_h0 in (True, False):
                cases[f"{name}-{impl}-{'h0' if learn_h0 else 'fixedh0'}"] = (
                    make, dict(gru_impl=impl, learn_h0=learn_h0), batch,
                    seq_len)
    cases["samplernn32-wavefront-direct"] = (
        narrow_samplernn, dict(gru_impl="wavefront", mlp_grad_impl="direct"),
        3, 160)
    # a width and batch the JAX kernel takes, so that JAX runs it (in
    # Pallas interpret mode) and not its scan fallback
    cases["samplernn128-pallas-b8"] = (
        lambda: narrow_samplernn(128), dict(gru_impl="pallas"), 8, 80)
    return cases


CASES = _cases()


# Adam's amplification (module docstring) grows with the width: at dim 128
# many gradient elements are below their own rounding error, their sign
# differs between the packages and each such update moves a weight by a full
# +-lr. That case is held to its losses and gradients only.
TRAJECTORY_CASES = [c for c in CASES if c != "samplernn128-pallas-b8"]
_RUNS = {}


def _runs(case):
    """Both packages' five steps of one case, computed once per process."""
    if case not in _RUNS:
        make, overrides, batch, seq_len = CASES[case]
        cfg = dataclasses.replace(make(), **overrides)
        jp, tp = both_params(cfg)
        chunks = _chunks(cfg, batch, seq_len, N_STEPS)
        _RUNS[case] = (cfg, _jax_run(cfg, jp, chunks, batch),
                       _torch_run(cfg, tp, chunks, batch), chunks, batch)
    return _RUNS[case]


@pytest.fixture(params=list(CASES))
def both_runs(request):
    return _runs(request.param)


@pytest.fixture(params=TRAJECTORY_CASES)
def trajectory_runs(request):
    return _runs(request.param)


def test_losses_match_jax(both_runs):
    _, (jl, *_), (tl, *_), _, _ = both_runs
    np.testing.assert_allclose(tl, jl, atol=LOSS_ATOL)
    assert tl[-1] < tl[0]


def test_first_step_gradients_match_jax(both_runs):
    cfg, (_, jg, *_), (_, tg, *_), _, _ = both_runs
    _assert_tree_close(tg, jg, GRAD_ATOL, "grad")
    if not cfg.learn_h0:
        assert all(float(tier["h0"].abs().max()) == 0.0
                   for tier in tg["tiers"])


def test_params_and_moments_match_jax(trajectory_runs):
    cfg, (_, _, jp, adam, _), (_, _, tp, o, _), _, _ = trajectory_runs
    _assert_tree_close(tp, jp, PARAM_ATOL, "param")
    _assert_tree_close(o["mu"], adam.mu, PARAM_ATOL, "mu")
    _assert_tree_close(o["nu"], adam.nu, PARAM_ATOL, "nu")
    assert o["count"] == int(adam.count) == N_STEPS
    if not cfg.learn_h0:
        assert all(float(tier["h0"].abs().max()) == 0.0
                   for tier in tp["tiers"])


def test_carried_state_matches_jax_and_is_detached(trajectory_runs):
    _, (*_, jstate), (*_, tstate), _, _ = trajectory_runs
    for a, b in zip(tstate, jstate):
        assert a.grad_fn is None and not a.requires_grad
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PARAM_ATOL)


def test_eval_step_equals_train_forward_and_jax(both_runs):
    """make_eval_step on the initial weights gives the loss the first train
    step reported (its forward ran before the update), in both packages."""
    cfg, (jl, *_), (tl, *_), chunks, batch = both_runs
    jp, tp = both_params(cfg)
    c = torch_cfg(cfg)
    data, target, cond, spk = _torch_inputs(chunks[0])
    loss, new_state = tstep.make_eval_step(c)(
        tp, init_tier_state(c, batch, device="cpu"), data, True, target,
        cond, spk)
    assert abs(float(loss) - tl[0]) <= 1e-6
    jdata, jtarget, jcond, jspk = chunks[0]
    jloss, _ = jstep.make_eval_step(cfg)(
        jp, jax_init_state(cfg, batch), jdata, jnp.asarray(True), jtarget,
        jcond, jspk)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert all(s.grad_fn is None for s in new_state)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_mixed_precision_tracks_f32(impl):
    """compute_dtype=bfloat16: f32 masters and moments, a loss within 0.05
    bits of the float32 run over the five steps (bf16 keeps 8 mantissa
    bits; at ~8.8 bits of loss that is well inside 0.05)."""
    cfg = dataclasses.replace(narrow_samplernn(), gru_impl=impl)
    chunks = _chunks(cfg, 3, 160, N_STEPS, seed=1)
    l32, *_ = _torch_run(cfg, both_params(cfg)[1], chunks, 3)
    l16, g16, p16, o16, s16 = _torch_run(cfg, both_params(cfg)[1], chunks, 3,
                                         compute_dtype=torch.bfloat16)
    assert np.all(np.isfinite(l16))
    assert np.max(np.abs(np.array(l16) - np.array(l32))) <= 0.05
    for leaf in (tree_leaves(p16) + tree_leaves(g16)
                 + tree_leaves(o16["mu"]) + s16):
        assert leaf.dtype == torch.float32


def test_step_updates_in_place_and_reset_gates_h0_grad():
    cfg = torch_cfg(tiny())
    _, tp = both_params(tiny())
    chunks = _chunks(tiny(), 4, 32, 2, seed=2)
    data, target, cond, spk = _torch_inputs(chunks[0])
    state = [s + 0.1 for s in init_tier_state(cfg, 4, device="cpu")]
    # the learned h0 gets a gradient only when reset substitutes it
    _, _, g_reset = tstep.loss_and_grads(tp, cfg, state, data, True, target,
                                         cond, spk)
    _, _, g_carry = tstep.loss_and_grads(tp, cfg, state, data, False, target,
                                         cond, spk)
    assert all(float(tr["h0"].abs().max()) > 0 for tr in g_reset["tiers"])
    assert all(float(tr["h0"].abs().max()) == 0 for tr in g_carry["tiers"])
    opt = toptim.make_optimizer(TorchTrainConfig(**TRAIN))
    o = opt.init(tp)
    leaf = tp["mlp"]["embedding"]
    before = leaf.clone()
    p2, o2, _, _ = tstep.make_train_step(cfg, opt)(
        tp, o, state, data, True, target, cond, spk)
    assert p2 is tp and o2 is o and not torch.equal(leaf, before)
    assert not any(x.requires_grad for x in tree_leaves(tp))


def test_indexed_steps_equal_tensor_steps_and_jax_slices():
    cfg = tiny()
    c = torch_cfg(cfg)
    seq_len, lb, batch, n = 32, cfg.lookback, 4, 3
    rng = np.random.RandomState(3)
    cond_in_seq = seq_len // lb
    corpus = {
        "qdata": rng.randint(0, 256, (batch, n * seq_len + lb))
        .astype(np.int32),
        "cond": rng.rand(batch, n * cond_in_seq + 1,
                         cfg.effective_cond_dim).astype(np.float32),
        "spk": rng.randint(0, cfg.spk_dim, (n, batch)).astype(np.int32)}
    tcorpus = {k: t(v) for k, v in corpus.items()}
    for k in range(n):
        want = jstep.chunk_slices(
            {kk: jnp.asarray(v) for kk, v in corpus.items()}, k, seq_len, lb,
            cond_in_seq)
        got = tstep.chunk_slices(tcorpus, k, seq_len, lb, cond_in_seq)
        assert got[1] == bool(want[1])
        for a, b in zip((got[0], got[2], got[3], got[4]),
                        (want[0], want[2], want[3], want[4])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    geo = (seq_len, lb, cond_in_seq)
    runs = []
    for indexed in (True, False):
        _, tp = both_params(cfg)
        opt = toptim.make_optimizer(TorchTrainConfig(**TRAIN))
        o = opt.init(tp)
        state = init_tier_state(c, batch, device="cpu")
        step_i = tstep.make_train_step_indexed(c, opt, *geo)
        step_t = tstep.make_train_step(c, opt)
        losses = []
        for k in range(n):
            if indexed:
                tp, o, state, loss = step_i(tp, o, state, tcorpus, k)
            else:
                data, reset, target, cond, spk = tstep.chunk_slices(
                    tcorpus, k, *geo)
                tp, o, state, loss = step_t(tp, o, state, data, reset, target,
                                            cond, spk.long())
            losses.append(float(loss))
        ev, _ = tstep.make_eval_step_indexed(c, *geo)(tp, state, tcorpus, 0)
        runs.append(losses + [float(ev)])
    assert runs[0] == runs[1]


def test_exposure_perturbation_statistics():
    """Bit equality with JAX's PRNG is impossible; the perturbation is held
    to its statistics and to what it must leave alone."""
    assert tstep.exposure_tuple(None) is None
    assert tstep.exposure_tuple(TorchTrainConfig()) is None
    exposure = tstep.exposure_tuple(TorchTrainConfig(
        ss_prob=0.5, input_noise_prob=0.25, input_noise_levels=4))
    assert exposure == jstep.exposure_tuple(TrainConfig(
        ss_prob=0.5, input_noise_prob=0.25, input_noise_levels=4))
    cfg = torch_cfg(tiny())
    _, tp = both_params(tiny())
    batch, seq_len, lb = 16, 64, cfg.lookback
    data, target, cond, spk = _torch_inputs(
        _chunks(tiny(), batch, seq_len, 1, seed=4)[0])
    state = init_tier_state(cfg, batch, device="cpu")
    g = torch.Generator().manual_seed(0)
    # input noise alone: ~25 % flipped, by at most 4 levels, in range
    noisy = tstep._perturb(tp, cfg, None, (0.0, 0.25, 4), state, data, True,
                           cond, spk, g)
    changed = (noisy != data).float().mean().item()
    # a flip with jitter 0 (1 in 9) or clamped back changes nothing
    assert 0.15 < changed < 0.27
    assert (noisy - data).abs().max().item() <= 4
    assert noisy.min() >= 0 and noisy.max() < cfg.q_levels
    # scheduled sampling alone: the lookback seed is untouched, about half
    # of the rest is replaced by draws from a near-uniform init model
    mixed = tstep._perturb(tp, cfg, None, (0.5, 0.0, 0), state, data, True,
                           cond, spk, g)
    assert mixed.shape == data.shape and mixed.dtype == data.dtype
    assert torch.equal(mixed[:, :lb], data[:, :lb])
    replaced = (mixed[:, lb:] != data[:, lb:]).float().mean().item()
    assert 0.4 < replaced < 0.6
    # the step takes the generator, leaves its targets alone and trains
    opt = toptim.make_optimizer(TorchTrainConfig(**TRAIN))
    step = tstep.make_train_step(cfg, opt, exposure=exposure)
    target_before = target.clone()
    _, _, _, loss = step(tp, opt.init(tp), state, data, True, target, cond,
                         spk, g)
    assert np.isfinite(float(loss)) and torch.equal(target, target_before)


def test_unported_entry_points_raise():
    cfg = torch_cfg(tiny())
    opt = toptim.make_optimizer(TorchTrainConfig())
    with pytest.raises(NotImplementedError, match="mesh"):
        tstep.make_train_step(cfg, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tstep.make_eval_step(cfg, mesh=object())
    for fn in (tstep.make_train_block_scan, tstep.make_eval_block_scan,
               tstep.eval_device_corpus):
        with pytest.raises(NotImplementedError, match="block-scan"):
            fn(cfg, opt, 32, 16, 2)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of msnv_tpu_torch in a fresh interpreter
    leaves jax, optax and msnv_tpu out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import msnv_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "msnv_tpu_torch.__path__, 'msnv_tpu_torch.')]\n"
        "for n in names:\n"
        "    if not n.endswith('__main__'):\n"
        "        importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'msnv_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'msnv_tpu_torch.training.step' in names\n"
        "assert 'msnv_tpu_torch.kernels.gru_layer' in names\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
