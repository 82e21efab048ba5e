"""The port's speaker discriminator (msnv_tpu_torch/models/discriminator.py)
against the JAX package's, on the CPU, with the weights crossing as numpy
under the checkpoint keys.

Tolerances, each with its reason:
  float32 log-probs, NLL, grads (params and latent)   1e-5
      8 channels, (4, 13, 10) latent: 5x5 convs summed in another order
      (XLA's CPU conv vs torch's), through four InstanceNorms
  bfloat16 log-probs                                  3e-2
      bf16 conv operands and outputs (8 significant bits, a relative step
      of 2**-8 = 3.9e-3 per rounding) in both packages, rounded at other
      points of other summation orders through eight convs; InstanceNorm
      statistics and the classifier stay float32 in both
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.models import discriminator as jd
from msnv_tpu.models.generate import cast_float_tree as jcast
from msnv_tpu_torch.interop import (disc_params_from_numpy,
                                    disc_params_to_numpy)
from msnv_tpu_torch.models import discriminator as td
from msnv_tpu_torch.models.generate import cast_float_tree as tcast
from msnv_tpu_torch.training.step import grad_leaves, grads_like
from msnv_tpu_torch.tree import tree_leaves
from torch_parity import t

SPK, CH = 3, 8


def _flat(disc):
    flat, _ = jax.tree_util.tree_flatten_with_path({"disc_params": disc})
    return {"leaf:" + jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _both(seed=0, channels=CH):
    jp = jd.discriminator_init(jax.random.PRNGKey(seed), SPK,
                               channels=channels)
    return jp, disc_params_from_numpy(_flat(jp), SPK, channels, device="cpu")


def _latent(shape=(4, 13, 10), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


SPK_IDS = np.array([0, 1, 2, 0], np.int32)


def test_tree_matches_jax_and_round_trips():
    jp, tp = _both()
    want = {k: v.shape for k, v in _flat(jp).items()}
    got = disc_params_to_numpy(tp)
    assert {k: v.shape for k, v in got.items()} == want
    assert "leaf:['disc_params']['blocks'][0]['conv2']['b']" not in got
    fresh = td.discriminator_init(torch.Generator().manual_seed(0), SPK, CH,
                                 device="cpu")
    assert {k: v.shape for k, v in disc_params_to_numpy(fresh).items()} \
        == want
    # kaiming_uniform over fan_in 5*5*in: |w| <= sqrt(6 / (25 * in))
    assert float(fresh["blocks"][1]["conv1"]["w"].abs().max()) <= \
        (6.0 / (25 * CH)) ** 0.5


def test_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """Like init_params, discriminator_init runs on `cuda` unless a device
    is passed, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.discriminator_init(torch.Generator().manual_seed(0), SPK, CH)


@pytest.mark.parametrize("shape", [(4, 13, 10), (2, 3, 3)])
def test_apply_nll_and_grads_match_jax(shape):
    jp, tp = _both()
    lat = _latent(shape)
    spk = SPK_IDS[:shape[0]]
    lp_j = jd.discriminator_apply(jp, jnp.asarray(lat))
    lp_t = td.discriminator_apply(tp, t(lat))
    assert lp_t.dtype == torch.float32 and lp_t.shape == (shape[0], SPK)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-5)

    l_j, (gp_j, gl_j) = jax.value_and_grad(jd.discriminator_nll,
                                           argnums=(0, 1))(
        jp, jnp.asarray(lat), jnp.asarray(spk))
    leaves = grad_leaves(tp)
    lat_t = t(lat).requires_grad_(True)
    l_t = td.discriminator_nll(leaves, lat_t, t(spk))
    *g_params, g_lat = torch.autograd.grad(l_t,
                                           tree_leaves(leaves) + [lat_t])
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), atol=1e-5)
    np.testing.assert_allclose(g_lat.numpy(), np.asarray(gl_j), atol=1e-5)
    got = disc_params_to_numpy(grads_like(leaves, g_params))
    want = _flat(gp_j)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                   err_msg=name)


def test_instance_norm_takes_the_population_variance():
    """A 3x3 map: the unbiased variance (torch.var's default) is 9/8 of
    the population one, which moves the normalized map by ~6 %; the port
    equals jnp.var's normalization to 1e-6."""
    x = _latent((2, 5, 3, 3), seed=7)
    want = np.asarray(jd._instance_norm(jnp.asarray(np.moveaxis(x, 1, -1))))
    got = td._instance_norm(t(x)).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, atol=1e-6)
    xt = t(x)
    unbiased = (xt - xt.mean(dim=(2, 3), keepdim=True)) * torch.rsqrt(
        xt.var(dim=(2, 3), keepdim=True) + 1e-5)
    off = np.abs(np.moveaxis(unbiased.numpy(), 1, -1) - want).max()
    assert off > 1e-2, off


def test_bf16_path_within_tolerance_and_statistics_in_f32():
    jp, tp = _both(seed=2)
    lat = _latent(seed=2)
    lp_j = jd.discriminator_apply(jcast(jp, jnp.bfloat16),
                                  jnp.asarray(lat, jnp.bfloat16))
    lp_t = td.discriminator_apply(tcast(tp, torch.bfloat16),
                                  t(lat).to(torch.bfloat16))
    assert lp_t.dtype == torch.float32
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=3e-2)
    # and bf16 tracks the float32 path at the same tolerance
    np.testing.assert_allclose(
        lp_t.numpy(), td.discriminator_apply(tp, t(lat)).numpy(), atol=3e-2)
    # InstanceNorm of a bf16 map: statistics in float32, output bf16
    x = t(_latent((1, 2, 4, 4), seed=3)).to(torch.bfloat16)
    y = td._instance_norm(x)
    assert y.dtype == torch.bfloat16
    want = td._instance_norm(x.float())
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
