"""The port's ops/xent.py against the JAX package's, on the CPU in float32.

Inputs come from a numpy seed and go through both. Tolerance 1e-6: the two
compute the same logsumexp and the same softmax in float32; only the order
of the sum over the q classes and of the mean can differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.ops.xent import nll_bits_from_logits as jax_nll
from msnv_tpu_torch.models.samplernn import sequence_nll_loss_bits
from msnv_tpu_torch.ops.xent import nll_bits_from_logits

import torch_parity  # noqa: F401  (sets the torch thread count)

ATOL = 1e-6


def _inputs(shape, q, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape, q).astype(np.float32) * scale,
            rng.randint(0, q, shape).astype(np.int32))


@pytest.mark.parametrize("shape,q", [((4, 24), 256), ((3,), 16),
                                     ((2, 5, 7), 32)])
def test_value_and_dlogits_match_jax(shape, q):
    logits, targets = _inputs(shape, q, seed=q)
    want, want_g = jax.value_and_grad(jax_nll)(jnp.asarray(logits),
                                               jnp.asarray(targets))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = nll_bits_from_logits(x, torch.from_numpy(targets))
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), atol=ATOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_matches_log_softmax_path_under_autograd(scale):
    """Same value and gradient as sequence_nll_loss_bits(log_softmax(.)),
    also for large logits (the logsumexp is shifted by the row maximum)."""
    logits, targets = _inputs((4, 24), 64, seed=1, scale=scale)
    tgt = torch.from_numpy(targets)
    a = torch.from_numpy(logits).requires_grad_(True)
    b = torch.from_numpy(logits).requires_grad_(True)
    fused = nll_bits_from_logits(a, tgt)
    plain = sequence_nll_loss_bits(torch.log_softmax(b, dim=-1), tgt)
    # the upstream cotangent scales the gradient
    (ga,) = torch.autograd.grad(2.5 * fused, a)
    (gb,) = torch.autograd.grad(2.5 * plain, b)
    np.testing.assert_allclose(fused.item(), plain.item(), atol=ATOL * scale)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=ATOL)


def test_targets_get_no_gradient_and_any_int_type():
    logits, targets = _inputs((2, 6), 8, seed=2)
    x = torch.from_numpy(logits).requires_grad_(True)
    vals = [nll_bits_from_logits(x, torch.from_numpy(targets).to(dt)).item()
            for dt in (torch.int32, torch.int64, torch.uint8)]
    assert vals[0] == vals[1] == vals[2]
