"""PyTorch port vs the JAX package: quantizers, dense, upsample, GRU, the
parameter tree, the predictor forward and checkpoint loading (CPU, f32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.models import samplernn as jsr
from msnv_tpu.ops import gru as jgru
from msnv_tpu.ops import linear as jlin
from msnv_tpu.ops import quantize as jq
from msnv_tpu.ops import upsample as jup
from msnv_tpu_torch.interop import (load_npz_params, param_keys,
                                    params_to_numpy)
from msnv_tpu_torch.models import samplernn as tsr
from msnv_tpu_torch.ops import gru as tgru
from msnv_tpu_torch.ops import linear as tlin
from msnv_tpu_torch.ops import quantize as tq
from msnv_tpu_torch.ops import upsample as tup
from torch_parity import (both_params, flat_numpy, narrow_samplernn, t,
                          tiny, torch_cfg)

ATOL = 1e-6


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("name", ["ulaw", "iulaw", "midrise", "imidrise",
                                  "uquantize", "udequantize",
                                  "linear_quantize", "linear_dequantize"])
def test_quantize_matches_jax(name):
    rng = np.random.RandomState(0)
    if name in ("imidrise", "udequantize", "linear_dequantize"):
        x = rng.randint(0, 256, (3, 50)).astype(np.int32)
    else:
        x = rng.uniform(-1, 1, (3, 50)).astype(np.float32)
    want = _np(getattr(jq, name)(x))
    got = getattr(tq, name)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert tq.q_zero(256) == jq.q_zero(256)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_dense_matches_jax(weight_norm):
    p = jlin.dense_init(jax.random.PRNGKey(1), 12, 7,
                        weight_norm=weight_norm)
    p["b"] = jnp.linspace(-1, 1, 7)
    x = np.random.RandomState(2).randn(4, 5, 12).astype(np.float32)
    want = _np(jlin.dense_apply(p, x))
    got = tlin.dense_apply({k: t(v) for k, v in p.items()}, t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_dense_init_shapes_and_bounds():
    g = torch.Generator().manual_seed(0)
    p = tlin.dense_init(g, 10, 6, weight_norm=True, device="cpu")
    assert p["w"].shape == (6, 10) and p["b"].shape == (6,)
    assert p["g"].shape == (6,)
    assert p["w"].abs().max() <= np.sqrt(6.0 / 10)
    # same seed, same weights
    p2 = tlin.dense_init(torch.Generator().manual_seed(0), 10, 6,
                         device="cpu")
    torch.testing.assert_close(p["w"], p2["w"], rtol=0, atol=0)
    w = tlin.orthogonal(g, (8, 8))
    torch.testing.assert_close(w @ w.T, torch.eye(8), atol=1e-5, rtol=0)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_upsample_matches_jax(weight_norm):
    p = jup.upsample_init(jax.random.PRNGKey(3), 8, 4, 6,
                          weight_norm=weight_norm)
    p["bias"] = jnp.asarray(np.random.RandomState(4).randn(4, 6), jnp.float32)
    tp = {k: t(v) for k, v in p.items()}
    x = np.random.RandomState(5).randn(2, 3, 8).astype(np.float32)
    np.testing.assert_allclose(tup.upsample_apply(tp, t(x)).numpy(),
                               _np(jup.upsample_apply(p, x)), atol=ATOL)
    np.testing.assert_allclose(tup.upsample_step(tp, t(x[:, 0])).numpy(),
                               _np(jup.upsample_step(p, x[:, 0])), atol=ATOL)


def _gru_pair(n_layers, in_dim=6, hidden=8):
    p = jgru.gru_init(jax.random.PRNGKey(7), n_layers, in_dim, hidden)
    rng = np.random.RandomState(8)
    for layer in p:          # non-zero biases exercise every term
        layer["b_ih"] = jnp.asarray(rng.randn(3 * hidden) * 0.1, jnp.float32)
        layer["b_hh"] = jnp.asarray(rng.randn(3 * hidden) * 0.1, jnp.float32)
    return p, [{k: t(v) for k, v in layer.items()} for layer in p]


@pytest.mark.parametrize("n_layers", [1, 2])
def test_gru_cell_matches_jax(n_layers):
    jp, tp = _gru_pair(n_layers)
    rng = np.random.RandomState(9)
    x = rng.randn(3, 6).astype(np.float32)
    h = rng.randn(n_layers, 3, 8).astype(np.float32)
    y_j, h_j = jgru.gru_cell(jp, x, h)
    y_t, h_t = tgru.gru_cell(tp, t(x), t(h))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), atol=ATOL)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_gru_apply_matches_jax(n_layers):
    jp, tp = _gru_pair(n_layers)
    rng = np.random.RandomState(10)
    x = rng.randn(2, 5, 6).astype(np.float32)
    h0 = rng.randn(n_layers, 2, 8).astype(np.float32)
    y_j, h_j = jgru.gru_apply(jp, x, h0)
    y_t, h_t = tgru.gru_apply(tp, t(x), t(h0))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), atol=ATOL)
    np.testing.assert_allclose(h_t.numpy(), _np(h_j), atol=ATOL)


@pytest.mark.parametrize("impl", ["cudnn", "scan"])
def test_gru_unported_impls_raise(impl):
    """"pallas" and "wavefront" are ported (tests/test_torch_gru_layer.py);
    a name that is no schedule is refused, not silently run as the loop."""
    _, tp = _gru_pair(2)
    with pytest.raises(ValueError, match="gru_impl"):
        tgru.gru_apply(tp, torch.zeros(1, 2, 6), torch.zeros(2, 1, 8), impl)


@pytest.mark.parametrize("cfg", [
    tiny(), narrow_samplernn(),
    dataclasses.replace(narrow_samplernn(), weight_norm=True),
    dataclasses.replace(tiny(), frame_sizes=(4, 5, 4)),
], ids=["tiny", "samplernn32", "samplernn32_wn", "three_tier"])
def test_param_tree_matches_jax(cfg):
    jparams, _ = both_params(cfg)
    want = {k: v.shape for k, v in flat_numpy(jparams).items()}
    tcfg = torch_cfg(cfg)
    assert sorted(param_keys(tcfg)) == sorted(want)
    tparams = tsr.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    got = {k: v.shape for k, v in params_to_numpy(tparams).items()}
    assert got == want


def _predictor_inputs(cfg, batch, seq_len, seed):
    rng = np.random.RandomState(seed)
    seqs = rng.randint(0, cfg.q_levels,
                       (batch, seq_len + cfg.lookback - 1)).astype(np.int32)
    cond = rng.rand(batch, seq_len // cfg.lookback,
                    cfg.effective_cond_dim).astype(np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,)).astype(np.int32)
    state = [rng.randn(cfg.n_rnn, batch, cfg.dim).astype(np.float32) * 0.5
             for _ in cfg.frame_sizes]
    return seqs, cond, spk, state


@pytest.mark.parametrize("reset", [True, False])
@pytest.mark.parametrize("which", ["tiny", "samplernn32"])
def test_predictor_matches_jax(which, reset):
    """Log-probs and new TBPTT state at the 5e-5 parity bar."""
    cfg = tiny() if which == "tiny" else narrow_samplernn()
    jparams, tparams = both_params(cfg, seed=1)
    # non-zero learned h0 so reset actually selects something
    rng = np.random.RandomState(11)
    for tier_j, tier_t in zip(jparams["tiers"], tparams["tiers"]):
        h0 = rng.randn(*tier_j["h0"].shape).astype(np.float32) * 0.3
        tier_j["h0"] = jnp.asarray(h0)
        tier_t["h0"] = t(h0)
    seq_len = 2 * cfg.lookback
    seqs, cond, spk, state = _predictor_inputs(cfg, 2, seq_len, 12)
    lp_j, st_j, _ = jsr.predictor_apply(jparams, cfg, jnp.asarray(seqs),
                                        jnp.asarray(reset),
                                        jnp.asarray(cond), jnp.asarray(spk),
                                        [jnp.asarray(s) for s in state])
    lp_t, st_t, _ = tsr.predictor_apply(tparams, torch_cfg(cfg), t(seqs),
                                        reset, t(cond), t(spk).long(),
                                        [t(s) for s in state])
    np.testing.assert_allclose(lp_t.numpy(), _np(lp_j), atol=5e-5)
    for a, b in zip(st_t, st_j):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=5e-5)
    tgt = np.random.RandomState(14).randint(
        0, cfg.q_levels, (2, seq_len)).astype(np.int32)
    np.testing.assert_allclose(
        float(tsr.sequence_nll_loss_bits(lp_t, t(tgt))),
        float(jsr.sequence_nll_loss_bits(lp_j, jnp.asarray(tgt))),
        rtol=1e-5)


def test_sample_mlp_logits_matches_jax():
    cfg = narrow_samplernn()
    jparams, tparams = both_params(cfg, seed=2)
    rng = np.random.RandomState(13)
    fs0 = cfg.frame_sizes[0]
    samples = rng.randint(0, 256, (2, 30 + fs0 - 1)).astype(np.int32)
    upper = rng.randn(2, 30, cfg.dim).astype(np.float32)
    want = _np(jsr.sample_mlp_logits(jparams["mlp"], cfg, samples, upper))
    got = tsr.sample_mlp_logits(tparams["mlp"], torch_cfg(cfg), t(samples),
                                t(upper)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_load_npz_written_by_jax_checkpoint(tmp_path):
    """A JAX-trainer checkpoint (params + optimizer-like extras) loads
    into the port with numpy alone, leaf for leaf."""
    from msnv_tpu.training.checkpoint import save_checkpoint
    cfg = narrow_samplernn()
    jparams, _ = both_params(cfg, seed=3)
    path = str(tmp_path / "ep1-it10.npz")
    save_checkpoint(path, {"params": jparams,
                           "opt_state": {"mu": jnp.ones((3,))}},
                    {"epoch": 1})
    tparams = load_npz_params(path, torch_cfg(cfg), device="cpu")
    want = flat_numpy(jparams)
    got = params_to_numpy(tparams)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # a checkpoint of another width is refused with the key named
    other = torch_cfg(dataclasses.replace(cfg, dim=16))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_npz_params(path, other, device="cpu")


def test_missing_key_is_named():
    from msnv_tpu_torch.interop import params_from_numpy
    cfg = tiny()
    flat = flat_numpy(both_params(cfg)[0])
    flat.pop("leaf:['params']['mlp']['embedding']")
    with pytest.raises(KeyError, match="embedding"):
        params_from_numpy(flat, torch_cfg(cfg), device="cpu")


def test_entry_points_refuse_missing_cuda():
    """No silent CPU fallback: without a card, the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsr.init_params(torch_cfg(tiny()))
