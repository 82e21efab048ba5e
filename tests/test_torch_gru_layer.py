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


def test_backward_takes_the_final_state_cotangent_beside_dy():
    """gru_layer_backward(dhT=...) counts dhT as added to dy[-1] and leaves
    the caller's dy as it was."""
    x = _inputs(4, 3, 32, seed=9)
    xp, w, b, h0 = (t(x[k]) for k in ("xp", "w", "b", "h0"))
    ys, hproj = gl.gru_layer_forward(xp, w, b, h0, torch.float32)
    dy, dhT = t(x["cy"]), t(x["ch"])
    kept = dy.clone()
    got = gl.gru_layer_backward(xp, hproj, h0, ys, dy, w.t(), torch.float32,
                                dhT=dhT)
    folded = dy.clone()
    folded[-1] += dhT
    want = gl.gru_layer_backward(xp, hproj, h0, ys, folded, w.t(),
                                 torch.float32)
    assert torch.equal(dy, kept)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


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


# --------------------------------------------------------------------------
# which kernels a sweep takes (sweep_plan is plain Python: no card needed)
# --------------------------------------------------------------------------

SMEM = 232448                               # a CTA's most on an H100
HELD = {"forward": 132, "backward": 120}    # CTAs resident at once at H 1024
HELD_F32 = {"forward": 132, "backward": 132}   # float32: clusters of 2
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("T,B,H,dtype,held,smem,want", [
    (52, 128, 1024, BF16, HELD, SMEM, "persistent"),   # the train step's
    (13, 128, 1024, BF16, HELD, SMEM, "persistent"),   # two tiers
    (1, 3, 1024, BF16, HELD, SMEM, "persistent"),      # T = 1, ragged B
    (4, 70, 128, BF16, HELD, SMEM, "persistent"),
    (52, 128, 1024, F32, HELD_F32, SMEM, "persistent"),   # split TF32
    (13, 128, 1024, F32, HELD_F32, SMEM, "persistent"),
    (1, 3, 1024, F32, HELD_F32, SMEM, "persistent"),
    (4, 70, 128, F32, HELD_F32, SMEM, "persistent"),
    (52, 129, 1024, F32, HELD_F32, SMEM, "per_step"),     # 256 CTAs
    (3, 300, 1024, F32, HELD_F32, SMEM, "per_step"),
    (52, 128, 1024, F32, {"forward": 132, "backward": 120}, SMEM,
     "per_step"),                                      # backward not resident
    (52, 128, 1024, F32, HELD_F32, 200 * 1024, "per_step"),  # 218 KiB a CTA
    (52, 128, 2048, F32, HELD_F32, SMEM, "per_step"),  # 384 KiB of weights
    (52, 128, 96, F32, HELD_F32, SMEM, "per_step"),    # H not 128's multiple
    (52, 129, 1024, BF16, HELD, SMEM, "per_step"),     # 192 CTAs forward
    (3, 300, 1024, BF16, HELD, SMEM, "per_step"),
    (52, 128, 1024, BF16, {"forward": 132, "backward": 56}, SMEM,
     "per_step"),                                      # backward not resident
    (52, 128, 1024, BF16, {"forward": 120, "backward": 120}, SMEM,
     "per_step"),                                      # forward not resident
    (52, 128, 2048, BF16, HELD, SMEM, "per_step"),     # slice > shared memory
    (52, 128, 1024, BF16, HELD, 160 * 1024, "per_step"),
])
def test_sweep_plan_chooses_by_shape(T, B, H, dtype, held, smem, want):
    plan = gl.sweep_plan(T, B, H, dtype, held, smem)
    assert plan.path == want
    cols = H // 16
    if want == "persistent":
        if dtype == BF16:
            assert plan.grids == {"forward": (cols, -(-B // 64)),
                                  "backward": (cols, -(-B // 128))}
        else:       # a cluster of 2 CTAs per 16 columns and 128-row tile
            assert plan.grids == dict.fromkeys(gl.DIRECTIONS,
                                               (2 * cols, -(-B // 128)))
        assert plan.smem_bytes == gl.persistent_smem_bytes(H, dtype)
        assert all(plan.grids[d][0] * plan.grids[d][1] <= held[d]
                   and plan.smem_bytes[d] <= smem for d in gl.DIRECTIONS)
    else:
        assert plan.grids == dict.fromkeys(gl.DIRECTIONS, (cols, -(-B // 64)))
        assert plan.smem_bytes == dict.fromkeys(gl.DIRECTIONS, 0)


@pytest.mark.parametrize("T,B,H,dtype,error", [
    (4, 8, 96, BF16, ValueError),       # H not a multiple of 128
    (4, 8, 64, BF16, ValueError),
    (4, 8, 40, F32, ValueError),        # H not a multiple of 32
    (0, 8, 128, BF16, ValueError),      # empty sweeps
    (4, 0, 128, F32, ValueError),
    (4, 8, 128, torch.float16, TypeError),
])
def test_sweep_plan_rejects_what_no_kernel_takes(T, B, H, dtype, error):
    with pytest.raises(error):
        gl.sweep_plan(T, B, H, dtype, HELD, SMEM)


def test_persistent_shared_memory_at_the_train_width():
    """At H 1024 both persistent kernels fit an H100's CTA; the cluster
    shapes in the module and the formula agree with what the source's plan
    states for them (forward 96 H + 64 rows x H / 2 x 2 bytes, backward
    96 H + 128 rows x 3H / 8 x 2 bytes)."""
    need = gl.persistent_smem_bytes(1024, BF16)
    assert need == {"forward": 96 * 1024 + 64 * 512 * 2,
                    "backward": 96 * 1024 + 128 * 384 * 2}
    assert max(need.values()) <= SMEM
    # a narrow layer: the partial sums, not the operand, set the size
    assert gl.persistent_smem_bytes(128, BF16)["backward"] == (
        96 * 128 + 8 * 128 * (16 + 4) * 4)


def test_f32_persistent_fits_an_h100_at_the_train_width():
    """At H 1024 a float32 persistent CTA holds its half of the depth of 48
    (forward) resp. 16 (backward) columns of W_hh twice, TF32 hi and lo
    parts (192 KiB), and the partial sums of 128 rows; it fits an H100's
    232,448 bytes, and each direction's grid (64 clusters of 2 at B 128) is
    at most the card's 132 SMs."""
    need = gl.persistent_smem_bytes(1024, F32)
    assert need == {"forward": 2 * 48 * 512 * 4 + 128 * (48 + 4) * 4,
                    "backward": 2 * 16 * 1536 * 4 + 128 * (16 + 4) * 4}
    assert max(need.values()) <= SMEM
    grids = gl.persistent_grids(128, 1024, F32)
    assert all(x * y <= 132 for x, y in grids.values())
    assert gl.sweep_plan(52, 128, 1024, F32, dict.fromkeys(gl.DIRECTIONS, 128),
                         max(need.values())).path == "persistent"


def _tf32_bits_clear(x):
    return bool(((x.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_split_rounds_to_nearest_ties_away():
    """tf32_split's parts are TF32 values (13 low mantissa bits zero),
    rounded as cvt.rna.tf32.f32 rounds, and add up to w within 2^-22 of
    it."""
    one = 1.0 + 2.0 ** -11                  # halfway between two TF32 values
    w = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0e-39, 0.0],
                     dtype=torch.float32)
    hi, lo = gl.tf32_split(w)
    assert hi.tolist()[:3] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert lo.tolist()[2] == 2.0 ** -12 and hi[4] == lo[4] == 0.0
    x = torch.from_numpy(np.random.RandomState(12).randn(4096).astype(
        np.float32))
    hi, lo = gl.tf32_split(x)
    assert _tf32_bits_clear(hi) and _tf32_bits_clear(lo)
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert err <= 2.0 ** -22


@pytest.mark.parametrize("K,N", [(1024, 3072), (3072, 1024)])
def test_split_tf32_product_holds_the_float32_tolerance(K, N):
    """The float32 persistent kernels' product emulated on the CPU at a
    sweep's shape (B 128; forward h (128 x 1024) . W_hh^T (1024 x 3072),
    backward dhproj (128 x 3072) . W_hh (3072 x 1024)): both operands split
    by tf32_split, the three TF32 products a_hi b_hi + a_hi b_lo + a_lo
    b_hi, each exact in float32 and summed in float32. Against float64 it
    stays inside chip_smoke.py's float32 tolerance (1e-4 of the largest
    value) with room: observed 4.9e-7 both ways, as close as a float32
    matmul of the unsplit operands (4.2e-7, 4.4e-7), where one TF32 product
    alone is off by 3.2e-4 and 2.4e-4, above the tolerance (values in the
    ranges of the state and of W_hh at init)."""
    rng = np.random.RandomState(K)
    a = rng.uniform(-1, 1, (128, K)).astype(np.float32)
    b = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    (a_hi, a_lo), (b_hi, b_lo) = gl.tf32_split(t(a)), gl.tf32_split(t(b))
    assert all(map(_tf32_bits_clear, (a_hi, a_lo, b_hi, b_lo)))
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    split = (a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi).numpy()
    one_pass = (a_hi @ b_hi).numpy()
    err = float(np.abs(split - want).max()) / scale
    err_one = float(np.abs(one_pass - want).max()) / scale
    assert err <= 1e-4
    assert err * 100 <= err_one


@pytest.mark.parametrize("dtype,atol", [
    # float32: one rounding per product against XLA's CPU dot, as above
    (torch.float32, ATOL),
    # bfloat16 weights and inputs, as the mixed-precision train step passes
    # them: both round the products' operands to bf16, but the JAX scan
    # carries h in bf16 from step to step where the kernel's wrapper carries
    # float32, and the gradients are rounded to bf16 (2^-9 of values up to
    # about 4) at different points of the two graphs; measured 1.4e-2 on y
    (torch.bfloat16, 6e-2),
])
def test_layer_apply_pallas_matches_jax_values_and_gradients(dtype, atol):
    """ops/gru._layer_apply(impl="pallas") on the CPU, which hands the
    kernel's wrapper the weight as the transposed view of what is stored,
    against the JAX package's _layer_apply (float32: through its kernel in
    interpret mode; bfloat16: through autograd of its scan, since its
    interpret mode computes in float32)."""
    B, T, d_in, H = 8, 5, 16, 128
    jp, tp = _gru_pair(1, d_in, H, seed=7)
    rng = np.random.RandomState(8)
    x = rng.randn(B, T, d_in).astype(np.float32)
    h0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    cy = rng.randn(B, T, H).astype(np.float32)
    ch = rng.randn(B, H).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    keys = ("w_ih", "w_hh", "b_ih", "b_hh")

    def jax_loss(p, xx, hh):
        p = {k: v.astype(jdt) for k, v in p.items()}
        y, hT = jgru._layer_apply(
            p, xx.astype(jdt), hh.astype(jdt),
            impl="pallas" if dtype == torch.float32 else "xla")
        y, hT = y.astype(jnp.float32), hT.astype(jnp.float32)
        return jnp.sum(y * cy) + jnp.sum(hT * ch), (y, hT)

    (_, (y_j, hT_j)), (gp_j, gx_j, gh_j) = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jp[0], jnp.asarray(x), jnp.asarray(h0))

    p = {k: tp[0][k].clone().requires_grad_(True) for k in keys}
    xx = t(x).requires_grad_(True)
    hh = t(h0).requires_grad_(True)
    y, hT = tgru._layer_apply({k: v.to(dtype) for k, v in p.items()},
                              xx.to(dtype), hh.to(dtype), impl="pallas")
    assert y.dtype == hT.dtype == dtype
    loss = (y.float() * t(cy)).sum() + (hT.float() * t(ch)).sum()
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [xx, hh])
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(y_j),
                               atol=atol)
    np.testing.assert_allclose(hT.float().detach().numpy(), np.asarray(hT_j),
                               atol=atol)
    want = [gp_j[k] for k in keys] + [gx_j, gh_j]
    for g, w_, name in zip(grads, want, keys + ("x", "h0")):
        scale = max(1.0, float(np.abs(np.asarray(w_)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w_, np.float32),
                                   atol=atol * scale, err_msg=name)
