"""The port's fused GRU layer (kernels/gru_layer.py) and the gru_apply
schedules against the JAX package's, on the CPU in float32.

The CUDA kernels cannot run here: on CPU tensors the wrapper runs their
plain versions, which these tests hold against the JAX kernel run in Pallas
interpret mode (float32 products), as the JAX package's own tests run it.
The kernels themselves are held against the same plain versions on the GPU
by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.ops import gru as jgru
from msnv_tpu.pallas.gru_kernel import gru_layer as jax_gru_layer
from msnv_tpu_torch.kernels import gru_layer as gl
from msnv_tpu_torch.ops import gru as tgru

from torch_parity import t

# float32 sums over H (and 3H backward) taken in another order by XLA's CPU
# dot than by torch's, compounded over the T steps of the recurrence
ATOL = 2e-5
# gru_apply outputs are bounded by tanh: one rounding per product
ATOL_APPLY = 1e-5


def _inputs(T, B, H, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "xp": (rng.randn(T, B, 3 * H) * 0.5).astype(np.float32),
        "w": (rng.randn(H, 3 * H) / np.sqrt(H)).astype(np.float32),
        "b": (rng.randn(3 * H) * 0.1).astype(np.float32),
        "h0": (rng.randn(B, H) * 0.5).astype(np.float32),
        "cy": rng.randn(T, B, H).astype(np.float32),
        "ch": rng.randn(B, H).astype(np.float32),
    }


def _jax_grads(x):
    """ys, hT and d(sum(ys*cy) + sum(hT*ch))/d(xp, w, b, h0) through the
    JAX kernel's custom VJP in interpret mode."""
    args = [jnp.asarray(x[k]) for k in ("xp", "w", "b", "h0")]

    def loss(xp, w, b, h0):
        ys, hT = jax_gru_layer(xp, w, b, h0, jnp.float32, True)
        return jnp.sum(ys * x["cy"]) + jnp.sum(hT * x["ch"]), (ys, hT)

    (_, (ys, hT)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return np.asarray(ys), np.asarray(hT), [np.asarray(g) for g in grads]


SHAPES = [(5, 8, 128), (8, 8, 128), (1, 8, 128)]


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_plain_forward_matches_jax_kernel(T, B, H):
    x = _inputs(T, B, H)
    ys_j, hT_j, _ = _jax_grads(x)
    ys, hproj = gl.gru_layer_reference(t(x["xp"]), t(x["w"]), t(x["b"]),
                                       t(x["h0"]))
    assert hproj.shape == (T, B, 3 * H)
    np.testing.assert_allclose(ys.numpy(), ys_j, atol=ATOL)
    np.testing.assert_allclose(ys[-1].numpy(), hT_j, atol=ATOL)


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_plain_backward_sweep_matches_jax_kernel(T, B, H):
    """The reverse sweep in tensor ops (what the backward kernel is held
    against on the GPU), with dw and db reduced outside it as the JAX
    package does."""
    x = _inputs(T, B, H, seed=1)
    _, _, (dxp_j, dw_j, db_j, dh0_j) = _jax_grads(x)
    xp, w, b, h0 = (t(x[k]) for k in ("xp", "w", "b", "h0"))
    ys, hproj = gl.gru_layer_reference(xp, w, b, h0)
    dy = t(x["cy"]).clone()
    dy[-1] += t(x["ch"])
    h_prev = torch.cat([h0[None], ys[:-1]])
    dxp, dhproj, dh0 = gl.gru_layer_backward_reference(
        xp, hproj, h_prev, dy, w.t())
    dw = torch.einsum("tbh,tbg->hg", h_prev, dhproj)
    db = dhproj.sum((0, 1))
    for got, want, name in ((dxp, dxp_j, "dxp"), (dw, dw_j, "dw"),
                            (db, db_j, "db"), (dh0, dh0_j, "dh0")):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("T,B,H", [(5, 8, 128), (6, 3, 32), (4, 1, 24)])
def test_function_matches_autograd_of_the_layer_loop(T, B, H):
    """The autograd.Function on CPU tensors (plain sweeps inside) against
    autograd through ops/gru._layer_apply's recurrence, also at shapes the
    JAX kernel does not take (odd B, H not a multiple of 128)."""
    x = _inputs(T, B, H, seed=2)

    def leaves():
        return [t(x[k]).requires_grad_(True) for k in ("xp", "w", "b", "h0")]

    def loss(ys, hT):
        return (ys * t(x["cy"])).sum() + (hT * t(x["ch"])).sum()

    a = leaves()
    ys, hT = gl.gru_layer(*a, torch.float32)
    got = torch.autograd.grad(loss(ys, hT), a)
    b = leaves()
    h, outs = b[3], []
    for step in range(T):
        h = tgru._gru_gates(b[0][step], torch.matmul(h, b[1]) + b[2], h)
        outs.append(h)
    want = torch.autograd.grad(loss(torch.stack(outs), h), b)
    np.testing.assert_allclose(ys.detach().numpy(),
                               torch.stack(outs).detach().numpy(), atol=1e-6)
    for g, w_, name in zip(got, want, ("dxp", "dw", "db", "dh0")):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=ATOL,
                                   err_msg=name)


def test_function_handles_missing_cotangents():
    """Only hT used (ys's cotangent is None) and only ys used."""
    x = _inputs(4, 2, 32, seed=3)
    for use in ("hT", "ys"):
        a = [t(x[k]).requires_grad_(True) for k in ("xp", "w", "b", "h0")]
        ys, hT = gl.gru_layer(*a, torch.float32)
        out = hT if use == "hT" else ys
        got = torch.autograd.grad(out.sum(), a)
        b = [t(x[k]).requires_grad_(True) for k in ("xp", "w", "b", "h0")]
        ys_p, _ = gl.gru_layer_reference(*b)
        ref = ys_p[-1] if use == "hT" else ys_p
        want = torch.autograd.grad(ref.sum(), b)
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=ATOL)


def test_no_grad_forward_saves_no_residual():
    x = _inputs(3, 2, 32)
    args = [t(x[k]) for k in ("xp", "w", "b", "h0")]
    ys, hproj = gl.gru_layer_forward(*args, torch.float32,
                                     with_residual=False)
    assert hproj is None
    with torch.no_grad():
        ys2, hT = gl.gru_layer(*args, torch.float32)
    assert torch.equal(ys, ys2) and torch.equal(hT, ys[-1])
    assert not ys2.requires_grad


def test_bf16_products_round_both_operands():
    """mxu_dtype=bfloat16: the recurrent product's operands are rounded to
    bf16, sums and state stay float32; within bf16 rounding of float32."""
    x = _inputs(6, 4, 64, seed=4)
    args = [t(x[k]) for k in ("xp", "w", "b", "h0")]
    ys16, hproj16 = gl.gru_layer_reference(*args, torch.bfloat16)
    ys32, _ = gl.gru_layer_reference(*args, torch.float32)
    assert ys16.dtype == hproj16.dtype == torch.float32
    err = (ys16 - ys32).abs().max().item()
    assert 0.0 < err < 0.05
    want = torch.matmul(args[3].bfloat16().float(),
                        args[1].bfloat16().float()) + args[2]
    assert torch.equal(hproj16[0], want)


@pytest.mark.parametrize("bad", ["w", "b", "h0", "dtype", "empty"])
def test_wrapper_rejects_bad_arguments(bad):
    x = _inputs(3, 2, 32)
    args = {k: t(x[k]) for k in ("xp", "w", "b", "h0")}
    dtype = torch.float32
    if bad == "w":
        args["w"] = args["w"].t().contiguous()
    elif bad == "b":
        args["b"] = args["b"][:-1]
    elif bad == "h0":
        args["h0"] = args["h0"][:1]
    elif bad == "dtype":
        dtype = torch.float16
    else:
        args["xp"] = args["xp"][:0]
    with pytest.raises((ValueError, TypeError)):
        gl.gru_layer_forward(args["xp"], args["w"], args["b"], args["h0"],
                             dtype)


def _gru_pair(n_layers, d_in, H, seed=0):
    jp = jgru.gru_init(jax.random.PRNGKey(seed), n_layers, d_in, H)
    rng = np.random.RandomState(seed)
    for p in jp:                       # non-zero biases exercise b_ih / b_hh
        p["b_ih"] = jnp.asarray(rng.randn(3 * H) * 0.1, jnp.float32)
        p["b_hh"] = jnp.asarray(rng.randn(3 * H) * 0.1, jnp.float32)
    tp = [{k: t(v) for k, v in p.items()} for p in jp]
    return jp, tp


@pytest.mark.parametrize("impl", ["pallas", "wavefront"])
@pytest.mark.parametrize("n_layers,B,T,d_in,H", [
    (2, 8, 5, 128, 128), (1, 8, 4, 16, 128), (3, 3, 6, 10, 24)])
def test_gru_apply_impls_match_xla_and_jax(impl, n_layers, B, T, d_in, H):
    jp, tp = _gru_pair(n_layers, d_in, H)
    rng = np.random.RandomState(5)
    x = rng.randn(B, T, d_in).astype(np.float32)
    h0 = (rng.randn(n_layers, B, H) * 0.5).astype(np.float32)
    y_j, h_j = jgru.gru_apply(jp, jnp.asarray(x), jnp.asarray(h0), impl=impl)
    y, h = tgru.gru_apply(tp, t(x), t(h0), impl)
    y_x, h_x = tgru.gru_apply(tp, t(x), t(h0), "xla")
    np.testing.assert_allclose(y.numpy(), y_x.numpy(), atol=ATOL_APPLY)
    np.testing.assert_allclose(h.numpy(), h_x.numpy(), atol=ATOL_APPLY)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL_APPLY)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=ATOL_APPLY)


@pytest.mark.parametrize("impl", ["pallas", "wavefront"])
def test_gru_apply_impls_gradients_match_xla(impl):
    _, tp = _gru_pair(2, 12, 32, seed=1)
    rng = np.random.RandomState(6)
    x = t(rng.randn(3, 5, 12).astype(np.float32))
    h0 = t((rng.randn(2, 3, 32) * 0.5).astype(np.float32))
    cy = t(rng.randn(3, 5, 32).astype(np.float32))

    def grads(which):
        ps = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for p in tp]
        hh = h0.clone().requires_grad_(True)
        y, h = tgru.gru_apply(ps, x, hh, which)
        leaves = [v for p in ps for v in p.values()] + [hh]
        return torch.autograd.grad((y * cy).sum() + h.sum(), leaves)

    for g, w_ in zip(grads(impl), grads("xla")):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=ATOL)


def test_gru_apply_pallas_bf16_keeps_dtype():
    _, tp = _gru_pair(2, 12, 32, seed=2)
    tp = [{k: v.bfloat16() for k, v in p.items()} for p in tp]
    x = torch.randn(2, 4, 12, generator=torch.Generator().manual_seed(0))
    y, h = tgru.gru_apply(tp, x.bfloat16(), torch.zeros(2, 2, 32).bfloat16(),
                          "pallas")
    assert y.dtype == h.dtype == torch.bfloat16
    assert y.shape == (2, 4, 32) and h.shape == (2, 2, 32)
