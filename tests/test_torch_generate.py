"""Generation in the PyTorch port vs the JAX package (CPU, f32): the
teacher-forcing equivalence, greedy sequences equal to JAX's, streaming ==
batch, K-frame pushes == K single pushes, and the kernel dispatch (on CPU:
the kernel's plain version on its Philox noise)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ModelConfig
from msnv_tpu.models import generate as jgen
from msnv_tpu.models.samplernn import init_tier_state, predictor_apply
from msnv_tpu_torch.kernels import sample_window as sw
from msnv_tpu_torch.models import generate as tgen
from msnv_tpu_torch.models import samplernn as tsr
from msnv_tpu_torch.ops.quantize import q_zero
from torch_parity import both_params, narrow_samplernn, t, torch_cfg


def _setup(cfg, batch=2, frames=3, seed=0):
    jparams, tparams = both_params(cfg, seed)
    rng = np.random.RandomState(seed)
    cond = rng.rand(batch, frames, cfg.effective_cond_dim).astype(np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,)).astype(np.int32)
    return jparams, tparams, cond, spk


def _gen(seed):
    return torch.Generator().manual_seed(seed)


SMALL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                    spk_dim=2)


def test_fused_table_matches_jax():
    jparams, tparams = both_params(SMALL)
    np.testing.assert_allclose(
        tgen.fused_embed_conv(tparams["mlp"]).numpy(),
        np.asarray(jgen.fused_embed_conv(jparams["mlp"])), atol=1e-5)


@pytest.mark.parametrize("frame_sizes,n_rnn", [((4, 4), 1), ((20, 4), 2),
                                               ((4, 5, 4), 1)])
def test_teacher_forcing_matches_jax_predictor(frame_sizes, n_rnn):
    cfg = ModelConfig(frame_sizes=frame_sizes, n_rnn=n_rnn, dim=24,
                      cond_dim=5, spk_dim=3)
    batch, frames = 2, 3
    jparams, tparams, cond, spk = _setup(cfg, batch, frames)
    T = frames * cfg.lookback
    forced = np.random.RandomState(1).randint(
        0, cfg.q_levels, (batch, T)).astype(np.int32)
    lp_t = tgen.teacher_forced_log_probs(tparams, torch_cfg(cfg))(
        t(cond), t(spk), t(forced))
    seed_buf = np.full((batch, cfg.lookback), q_zero(cfg.q_levels), np.int32)
    full = np.concatenate([seed_buf, forced], axis=1)
    lp_j, _, _ = predictor_apply(jparams, cfg, jnp.asarray(full[:, :-1]),
                                 jnp.asarray(True), jnp.asarray(cond),
                                 jnp.asarray(spk), init_tier_state(cfg, batch))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=5e-5)
    # and the port's own predictor agrees with its generation machinery
    lp_p, _, _ = tsr.predictor_apply(
        tparams, torch_cfg(cfg), t(full[:, :-1]), True, t(cond), t(spk),
        tsr.init_tier_state(torch_cfg(cfg), batch, device="cpu"))
    np.testing.assert_allclose(lp_t.numpy(), lp_p.numpy(), atol=5e-5)


@pytest.mark.parametrize("which", ["two_tier", "three_tier", "samplernn32",
                                   "speaker_mix"])
def test_greedy_sequences_equal_jax(which):
    cfg = {"two_tier": SMALL,
           "three_tier": dataclasses.replace(SMALL, frame_sizes=(4, 5, 4)),
           "samplernn32": narrow_samplernn(),
           "speaker_mix": SMALL}[which]
    jparams, tparams, cond, spk = _setup(cfg, batch=2, frames=2, seed=4)
    if which == "speaker_mix":
        spk = np.random.RandomState(5).dirichlet(
            np.ones(cfg.spk_dim), 2).astype(np.float32)
    audio_j, seq_j = jgen.generate_fn(jparams, cfg, temperature=0.0)(
        jnp.asarray(cond), jnp.asarray(spk), jax.random.PRNGKey(0))
    audio_t, seq_t = tgen.generate_fn(tparams, torch_cfg(cfg),
                                      temperature=0.0)(t(cond), t(spk))
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    np.testing.assert_allclose(audio_t.numpy(), np.asarray(audio_j),
                               atol=1e-6)
    assert audio_t.shape == (2, 2 * cfg.lookback)   # output-length quirk


def test_generate_sanity_and_determinism():
    _, tparams, cond, spk = _setup(SMALL, batch=3, frames=4)
    gen = tgen.generate_fn(tparams, torch_cfg(SMALL))
    audio, seq = gen(t(cond), t(spk), _gen(42))
    assert audio.shape == seq.shape == (3, 4 * SMALL.lookback)
    assert int(seq.min()) >= 0 and int(seq.max()) < SMALL.q_levels
    assert torch.isfinite(audio).all() and float(audio.abs().max()) <= 1.0
    _, seq2 = gen(t(cond), t(spk), _gen(7))
    _, seq3 = gen(t(cond), t(spk), _gen(42))
    assert not torch.equal(seq, seq2)
    assert torch.equal(seq, seq3)


@pytest.mark.parametrize("temperature", [1.0, 0.5, 0.0])
def test_streaming_matches_batch(temperature):
    _, tparams, cond, spk = _setup(SMALL, batch=2, frames=5)
    cfg = torch_cfg(SMALL)
    _, seq = tgen.generate_fn(tparams, cfg, temperature=temperature)(
        t(cond), t(spk), _gen(11))
    init_state, push = tgen.streaming_fn(tparams, cfg,
                                         temperature=temperature)
    carry = init_state(2, t(spk), _gen(11))
    outs = []
    for f in range(cond.shape[1]):
        carry, audio, s = push(carry, t(cond[:, f]))
        assert audio.shape == (2, SMALL.lookback)
        outs.append(s)
    torch.testing.assert_close(torch.cat(outs, 1), seq, rtol=0, atol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multi_frame_push_matches_single(use_kernel):
    _, tparams, _, _ = _setup(SMALL)
    cfg = torch_cfg(SMALL)
    rng = np.random.RandomState(3)
    B, K, total = 2, 3, 6
    cond = t(rng.rand(B, total, 5).astype(np.float32))
    spk = torch.tensor([1, 0])
    init1, push1 = tgen.streaming_fn(tparams, cfg, use_kernel=use_kernel)
    carry = init1(B, spk, _gen(5))
    singles = []
    for f in range(total):
        carry, _, s = push1(carry, cond[:, f])
        singles.append(s)
    initk, pushk = tgen.streaming_fn(tparams, cfg, use_kernel=use_kernel,
                                     frames_per_push=K)
    carry = initk(B, spk, _gen(5))
    chunks = []
    for c in range(total // K):
        carry, audio, s = pushk(carry, cond[:, c * K:(c + 1) * K])
        assert audio.shape == (B, K * SMALL.lookback)
        chunks.append(s)
    torch.testing.assert_close(torch.cat(chunks, 1), torch.cat(singles, 1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("frame_sizes", [(4, 4), (4, 5, 4)])
def test_kernel_path_sharpened_matches_greedy(frame_sizes):
    """With an argmax-dominant output layer, the kernel dispatch (on CPU:
    the plain version on Philox noise) reproduces greedy decoding."""
    cfg = dataclasses.replace(SMALL, frame_sizes=frame_sizes)
    _, tparams, cond, spk = _setup(cfg, batch=4, frames=3, seed=1)
    out = tparams["mlp"]["out"]
    tparams["mlp"]["out"] = {"w": out["w"] * 1e6, "b": out["b"] * 1e6}
    tcfg = torch_cfg(cfg)
    _, seq_g = tgen.generate_fn(tparams, tcfg, temperature=0.0)(
        t(cond), t(spk))
    _, seq_k = tgen.generate_fn(tparams, tcfg, use_kernel=True)(
        t(cond), t(spk), _gen(3))
    mismatch = (seq_k != seq_g).float().mean().item()
    assert mismatch < 0.02, mismatch


def test_kernel_path_temperature_is_argmax_invariant(monkeypatch):
    """argmax(logits/T) == argmax(logits): with zero noise the kernel
    sampler gives the same samples for any T > 0 (T enters as scaled
    W_o / b_o)."""
    cfg = dataclasses.replace(SMALL, q_levels=16)
    _, tparams = both_params(cfg)
    tcfg = torch_cfg(cfg)
    fused = tgen.fused_embed_conv(tparams["mlp"])
    monkeypatch.setattr(sw, "philox_gumbel_noise",
                        lambda seed, b, fs0, q: torch.zeros(b, fs0, q))
    slots = 0.1 * torch.randn(8, cfg.frame_sizes[0], cfg.dim,
                              generator=_gen(1))
    outs = []
    for T in (1.0, 0.37):
        run = tgen._kernel_window_sampler(tparams, tcfg, fused, T)
        buf = torch.full((8, cfg.lookback), q_zero(cfg.q_levels),
                         dtype=torch.int32)
        outs.append(run(buf, _gen(2), slots)[1])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_kernel_sampler_rejects_greedy():
    _, tparams = both_params(SMALL)
    fused = tgen.fused_embed_conv(tparams["mlp"])
    with pytest.raises(ValueError):
        tgen._kernel_window_sampler(tparams, torch_cfg(SMALL), fused, 0.0)


@pytest.mark.parametrize("bad", [-0.5, float("nan"), float("inf")])
def test_temperature_rejects_bad_values(bad):
    _, tparams = both_params(SMALL)
    with pytest.raises(ValueError):
        tgen.generate_fn(tparams, torch_cfg(SMALL), temperature=bad)


def test_bf16_generation_runs():
    _, tparams, cond, spk = _setup(SMALL, batch=2, frames=2)
    for use_kernel in (False, True):
        audio, seq = tgen.generate_fn(tparams, torch_cfg(SMALL),
                                      compute_dtype=torch.bfloat16,
                                      use_kernel=use_kernel)(
            t(cond), t(spk), _gen(0))
        assert audio.dtype == torch.float32 and seq.dtype == torch.int32
        assert audio.shape == (2, 2 * SMALL.lookback)
        assert torch.isfinite(audio).all()


def test_kernel_path_needs_two_tiers():
    cfg = dataclasses.replace(SMALL, frame_sizes=(4,))
    _, tparams = both_params(cfg)
    with pytest.raises(ValueError):
        tgen.generate_fn(tparams, torch_cfg(cfg), use_kernel=True)
