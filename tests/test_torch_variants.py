"""The bottleneck and GAN conditioner heads in the port against the JAX
package, on the CPU in float32: the latent and the log-probs, greedy
generation and streaming, and JAX-written checkpoints of each variant.

Tolerances, each with its reason:
  latent, log-probs       5e-5   the docs/DESIGN.md parity bar
  greedy sequences        equal  argmax of logits within 5e-5 of each
                                 other, on untied inputs
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msnv_tpu.config import ModelConfig
from msnv_tpu.models import generate as jgen
from msnv_tpu.models.samplernn import init_tier_state, predictor_apply
from msnv_tpu.training.checkpoint import save_checkpoint as jax_save
from msnv_tpu_torch.interop import (load_npz_params, param_keys,
                                    params_to_numpy)
from msnv_tpu_torch.models import generate as tgen
from msnv_tpu_torch.models import samplernn as tsr
from msnv_tpu_torch.models.conditioner import conditioner_apply
from msnv_tpu_torch.tree import tree_leaves
from torch_parity import both_params, flat_numpy, narrow_samplernn, t, \
    torch_cfg

SMALL = ModelConfig(frame_sizes=(4, 4), n_rnn=1, dim=16, cond_dim=5,
                    spk_dim=3, ind_cond_dim=6)
HEADS = {
    "bottleneck": dataclasses.replace(SMALL, variant="bottleneck"),
    "gan": dataclasses.replace(SMALL, variant="gan"),
    "gan_weight_norm": dataclasses.replace(SMALL, variant="gan",
                                           weight_norm=True),
    # the presets' head widths at a narrow dim: 86 look-ahead dims
    "bottleneck_preset": dataclasses.replace(
        narrow_samplernn(), variant="bottleneck", ind_cond_dim=30),
    "gan_preset": dataclasses.replace(
        narrow_samplernn(), variant="gan", ind_cond_dim=50,
        weight_norm=True),
}


def _inputs(cfg, batch=2, n_frames=3, seed=0):
    rng = np.random.RandomState(seed)
    seq_len = n_frames * cfg.lookback
    data = rng.randint(0, cfg.q_levels,
                       (batch, seq_len + cfg.lookback - 1)).astype(np.int32)
    cond = rng.rand(batch, n_frames, cfg.effective_cond_dim).astype(
        np.float32)
    spk = rng.randint(0, cfg.spk_dim, (batch,)).astype(np.int32)
    return data, cond, spk


@pytest.mark.parametrize("name", sorted(HEADS))
def test_latent_and_log_probs_match_jax(name):
    cfg = HEADS[name]
    jp, tp = both_params(cfg)
    stack = tp["tiers"][-1]["conditioner"]["stack"]
    widths = [layer["w"].shape[0] for layer in stack]
    c = cfg.effective_cond_dim
    assert widths == ([40, 30, 20, cfg.ind_cond_dim]
                      if cfg.variant == "bottleneck"
                      else [c, c, cfg.ind_cond_dim])
    assert all(("g" in layer) == cfg.weight_norm for layer in stack)
    data, cond, spk = _inputs(cfg)
    lp_j, _, lat_j = predictor_apply(
        jp, cfg, jnp.asarray(data), jnp.asarray(True), jnp.asarray(cond),
        jnp.asarray(spk), init_tier_state(cfg, 2))
    tcfg = torch_cfg(cfg)
    lp_t, _, lat_t = tsr.predictor_apply(
        tp, tcfg, t(data), True, t(cond), t(spk),
        tsr.init_tier_state(tcfg, 2, device="cpu"))
    assert lat_t.shape == (2, 3, cfg.ind_cond_dim)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), atol=5e-5)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=5e-5)
    # the stack's last layer has no ReLU: the latent takes negative values
    assert float(lat_t.min()) < 0


def test_identity_head_has_no_latent():
    _, tp = both_params(SMALL)
    tcfg = torch_cfg(SMALL)
    assert "stack" not in tp["tiers"][-1]["conditioner"]
    _, latent = conditioner_apply(tp["tiers"][-1]["conditioner"], tcfg,
                                  t(np.zeros((1, 2, 5), np.float32)))
    assert latent is None
    with pytest.raises(ValueError, match="variant"):
        tsr.init_params(dataclasses.replace(tcfg, variant="nope"),
                        device="cpu")


@pytest.mark.parametrize("name", ["bottleneck", "gan_weight_norm"])
def test_greedy_generation_and_streaming_equal_jax(name):
    cfg = HEADS[name]
    jp, tp = both_params(cfg, seed=4)
    rng = np.random.RandomState(4)
    cond = rng.rand(2, 3, cfg.effective_cond_dim).astype(np.float32)
    spk = np.array([1, 2], np.int32)
    _, seq_j = jgen.generate_fn(jp, cfg, temperature=0.0)(
        jnp.asarray(cond), jnp.asarray(spk), jax.random.PRNGKey(0))
    tcfg = torch_cfg(cfg)
    _, seq_t = tgen.generate_fn(tp, tcfg, temperature=0.0)(t(cond), t(spk))
    np.testing.assert_array_equal(seq_t.numpy(), np.asarray(seq_j))
    # streaming, one frame a push, in both packages
    j_init, j_push = jgen.streaming_fn(jp, cfg, temperature=0.0)
    t_init, t_push = tgen.streaming_fn(tp, tcfg, temperature=0.0)
    jc, tc = j_init(2, jnp.asarray(spk)), t_init(2, t(spk))
    for f in range(cond.shape[1]):
        jc, _, sj = j_push(jc, jnp.asarray(cond[:, f]))
        tc, _, st = t_push(tc, t(cond[:, f]))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(
            st.numpy(), seq_t[:, f * cfg.lookback:(f + 1) * cfg.lookback])


@pytest.mark.parametrize("name", ["bottleneck", "gan"])
def test_jax_written_npz_loads_in_the_port(name, tmp_path):
    cfg = HEADS[name]
    jp, _ = both_params(cfg, seed=2)
    path = str(tmp_path / "variant.npz")
    jax_save(path, {"params": jp})
    assert set(param_keys(torch_cfg(cfg))) == set(flat_numpy(jp))
    tp = load_npz_params(path, torch_cfg(cfg), device="cpu")
    want = flat_numpy(jp)
    got = params_to_numpy(tp)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in got)
    assert len(tree_leaves(tp)) == len(want)
    # an identity model's checkpoint lacks the variant's stack
    id_path = str(tmp_path / "identity.npz")
    jax_save(id_path, {"params": both_params(SMALL)[0]})
    with pytest.raises(KeyError, match="stack"):
        load_npz_params(id_path, torch_cfg(cfg), device="cpu")


@pytest.mark.parametrize("name", ["gan_weight_norm", "qrnn"])
def test_service_greedy_synthesize_equals_jax_service(name):
    """The HTTP service reaches the variants through the generation code:
    greedy /synthesize WAV bytes equal the JAX service's."""
    import http.client
    import json
    import threading

    from msnv_tpu.serving import VocoderService as JaxService
    from msnv_tpu.serving import make_server as jax_make_server
    from msnv_tpu_torch.serving import VocoderService, make_server
    cfg = (HEADS[name] if name in HEADS
           else dataclasses.replace(SMALL, qrnn=True))
    jp, tp = both_params(cfg, seed=6)
    cond = np.random.RandomState(6).rand(5, cfg.effective_cond_dim)
    body = json.dumps({"cond": cond.tolist(), "spk": 2, "temperature": 0.0})
    wavs = []
    for srv in (jax_make_server(JaxService(jp, cfg, frame_bucket=4), port=0),
                make_server(VocoderService(tp, torch_cfg(cfg),
                                           frame_bucket=4), port=0)):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            c = http.client.HTTPConnection(*srv.server_address, timeout=300)
            c.request("POST", "/synthesize", body,
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            assert r.status == 200
            wavs.append(r.read())
        finally:
            srv.shutdown()
            srv.server_close()
    assert wavs[0] == wavs[1] and len(wavs[0]) == 44 + 2 * 5 * cfg.lookback
