"""The port's ops/embed_conv.py against the JAX package's, on the CPU in
float32. Inputs come from a numpy seed and go through both.

Tolerance 2e-5: `embed_conv` reassociates the products (forward through the
fused table E @ w[j], backward through dT), so sums of up to k * e float32
terms are taken in another order than the embed-then-conv formulation's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.ops import embed_conv as jec
from msnv_tpu_torch.ops.embed_conv import embed_conv, embed_conv_direct

import torch_parity  # noqa: F401  (sets the torch thread count)

ATOL = 2e-5
SHAPES = [  # (q, e, k, h, B, S)
    (16, 16, 4, 8, 3, 19),
    (32, 12, 5, 24, 2, 40),
    (8, 8, 1, 4, 2, 6),
    (8, 8, 6, 4, 1, 6),          # a single output position
]


def _inputs(q, e, k, h, B, S, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(q, e).astype(np.float32),
            (rng.randn(k, e, h) / np.sqrt(k * e)).astype(np.float32),
            rng.randint(0, q, (B, S)).astype(np.int32),
            rng.randn(B, S - k + 1, h).astype(np.float32))


def _torch_run(fn, emb, w, samples, dy):
    e = torch.from_numpy(emb).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = fn(e, wt, torch.from_numpy(samples))
    de, dw = torch.autograd.grad(y, (e, wt), torch.from_numpy(dy))
    return y.detach().numpy(), de.numpy(), dw.numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("impl", ["fused", "direct"])
def test_forward_and_grads_match_jax(shape, impl):
    emb, w, samples, dy = _inputs(*shape)
    jfn = jec.embed_conv if impl == "fused" else jec.embed_conv_direct
    y_j, vjp = jax.vjp(lambda e, ww: jfn(e, ww, jnp.asarray(samples)),
                       jnp.asarray(emb), jnp.asarray(w))
    de_j, dw_j = vjp(jnp.asarray(dy))
    tfn = embed_conv if impl == "fused" else embed_conv_direct
    y_t, de_t, dw_t = _torch_run(tfn, emb, w, samples, dy)
    assert y_t.shape == (shape[4], shape[5] - shape[2] + 1, shape[3])
    np.testing.assert_allclose(y_t, np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(de_t, np.asarray(de_j), atol=ATOL)
    np.testing.assert_allclose(dw_t, np.asarray(dw_j), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_matches_direct_under_autograd(shape):
    emb, w, samples, dy = _inputs(*shape, seed=1)
    fused = _torch_run(embed_conv, emb, w, samples, dy)
    direct = _torch_run(embed_conv_direct, emb, w, samples, dy)
    for a, b, name in zip(fused, direct, ("y", "dE", "dw")):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_window_shift_does_not_leak_across_batch_rows():
    """dT is taken on the flattened (B*S) stream: a shift by j must not
    pair row b's cotangents with row b+1's samples. Two rows with disjoint
    sample alphabets: dE of the unused levels stays exactly zero."""
    q, e, k, h, S = 8, 4, 3, 5, 9
    rng = np.random.RandomState(3)
    emb, w = rng.randn(q, e).astype(np.float32), \
        rng.randn(k, e, h).astype(np.float32)
    samples = np.stack([rng.randint(0, 3, S), rng.randint(4, 7, S)]) \
        .astype(np.int32)
    dy = np.zeros((2, S - k + 1, h), np.float32)
    dy[0] = rng.randn(S - k + 1, h)              # only row 0 has cotangents
    _, de, _ = _torch_run(embed_conv, emb, w, samples, dy)
    assert np.all(de[3:] == 0.0) and np.any(de[:3] != 0.0)


def test_bf16_runs_and_stays_close():
    """bfloat16 (the mixed-precision train step's type): same function to
    bf16 rounding (8 mantissa bits: 2^-8 relative per rounded value)."""
    emb, w, samples, dy = _inputs(32, 12, 5, 24, 2, 40, seed=4)
    e = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    y = embed_conv(e, wt, torch.from_numpy(samples))
    de, dw = torch.autograd.grad(y, (e, wt),
                                 torch.from_numpy(dy).to(torch.bfloat16))
    assert y.dtype == de.dtype == dw.dtype == torch.bfloat16
    y32, de32, dw32 = _torch_run(embed_conv, emb, w, samples, dy)
    for a, b in ((y, y32), (de, de32), (dw, dw32)):
        scale = np.abs(b).max()
        assert np.abs(a.detach().float().numpy() - b).max() <= 0.03 * scale
