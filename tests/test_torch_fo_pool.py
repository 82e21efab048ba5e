"""The fused fo-pool (msnv_tpu_torch/kernels/fo_pool.py) on the CPU, where
it runs its plain versions, and the QRNN-tier train step against the
benchmark's plain reference (h100_bench/reference/samplernn_qrnn.py).

Tolerances, each with its reason:
  pool against the cell's loop   1e-6   float32: the same recurrence, the
                                        gates from one product over all T
                                        against one a step
  bf16 g                         equal  c is carried in float32 whatever
                                        g's type: only h is rounded
  gradients (float64)            1e-10  the reverse sweep's formulas
                                        against autograd of the loop
  carried chunks                 equal  the same steps in the same order
  train step (float32)           2e-5 (losses, relative), 1e-4 (norms of
                                 the first gradient and of each leaf's
                                 change, relative to the larger of the
                                 leaf's and the median leaf's): sums in
                                 another order through three Adam steps

Torch, the port and the benchmark only: no JAX.
"""

import statistics

import pytest
import torch

from h100_bench.reference import samplernn_qrnn as ref_qrnn
from msnv_tpu_torch.config import ModelConfig, TrainConfig
from msnv_tpu_torch.kernels import fo_pool as fp
from msnv_tpu_torch.models import samplernn as tsr
from msnv_tpu_torch.ops import qrnn as tq
from msnv_tpu_torch.training.optim import make_optimizer
from msnv_tpu_torch.training.step import make_train_step
from msnv_tpu_torch.tree import tree_leaves, tree_map
from msnv_tpu_torch.utils import profiling


def _gates_and_state(B=3, T=7, H=8, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, 3 * H, generator=g).to(dtype),
            torch.randn(B, H, generator=g).to(dtype))


def test_plain_pool_matches_the_cell_loop():
    """One layer through fo_pool against ops/qrnn.py's step, qrnn_cell."""
    p = tq.qrnn_init(torch.Generator().manual_seed(1), 1, 6, 8)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 9, 6, generator=g)
    c = torch.randn(1, 3, 8, generator=g)
    y, cT = tq.qrnn_apply(p, x, c)
    ys = []
    for t in range(x.shape[1]):
        yt, c = tq.qrnn_cell(p, x[:, t], c)
        ys.append(yt)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=0, atol=1e-6)
    torch.testing.assert_close(cT, c, rtol=0, atol=1e-6)


def test_bf16_gates_pool_in_float32():
    g, c0 = _gates_and_state()
    gb = g.to(torch.bfloat16)
    h, cT = fp.fo_pool(gb, c0)
    h32, cT32 = fp.fo_pool(gb.float(), c0)
    assert h.dtype == torch.bfloat16 and cT.dtype == torch.float32
    assert torch.equal(h, h32.to(torch.bfloat16))
    assert torch.equal(cT, cT32)


def _loop(g, c0):
    """The recurrence from the equations, step by step, for autograd."""
    H = c0.shape[-1]
    c, hs = c0, []
    for t in range(g.shape[1]):
        z = torch.tanh(g[:, t, :H])
        f = torch.sigmoid(g[:, t, H:2 * H])
        o = torch.sigmoid(g[:, t, 2 * H:])
        c = f * c + (1.0 - f) * z
        hs.append(o * c)
    return torch.stack(hs, 1), c


@pytest.mark.parametrize("with_dcT", [False, True])
def test_gradients_match_autograd_of_the_loop(with_dcT):
    g, c0 = _gates_and_state(dtype=torch.float64, seed=3)
    r = torch.Generator().manual_seed(4)
    dh = torch.randn(g.shape[:2] + c0.shape[1:], generator=r,
                     dtype=torch.float64)
    dcT = torch.randn(c0.shape, generator=r, dtype=torch.float64)

    def grads(fn):
        gg = g.clone().requires_grad_(True)
        cc = c0.clone().requires_grad_(True)
        h, cT = fn(gg, cc)
        loss = (h * dh).sum() + ((cT * dcT).sum() if with_dcT else 0.0)
        return torch.autograd.grad(loss, (gg, cc))

    for got, want in zip(grads(fp.fo_pool), grads(_loop)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def test_unused_final_cell_reaches_the_backward_as_none(monkeypatch):
    """A loss on h alone: c_T's cotangent is None where the backward sweep
    is called (no zero-filled (B, H) made), and the gradients equal those
    of the sweep given an explicit zero dc_T."""
    g, c0 = _gates_and_state(seed=7)
    dh = torch.randn(g.shape[:2] + c0.shape[1:],
                     generator=torch.Generator().manual_seed(8))
    seen = []
    sweep = fp.fo_pool_backward

    def recorded(g_, c0_, cs, dh_, dcT=None):
        seen.append(dcT)
        return sweep(g_, c0_, cs, dh_, dcT)

    monkeypatch.setattr(fp, "fo_pool_backward", recorded)
    gg, cc = g.clone().requires_grad_(True), c0.clone().requires_grad_(True)
    h, _ = fp.fo_pool(gg, cc)
    got = torch.autograd.grad((h * dh).sum(), (gg, cc))
    assert seen == [None]
    _, cs, _ = fp.fo_pool_reference(g, c0)
    want = fp.fo_pool_backward_reference(g, c0, cs, dh, torch.zeros_like(c0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gradcheck_float64():
    g, c0 = _gates_and_state(B=2, T=4, H=3, dtype=torch.float64, seed=5)
    assert torch.autograd.gradcheck(
        fp.fo_pool, (g.requires_grad_(True), c0.requires_grad_(True)))


def test_carry_across_two_chunks_equals_one_chunk():
    """c carried from a chunk of 3 steps into one of 4: the outputs, the
    final cell and every gradient of one chunk of 7."""
    g, c0 = _gates_and_state(T=7, seed=6)

    def run(split):
        gg = g.clone().requires_grad_(True)
        cc = c0.clone().requires_grad_(True)
        if split:
            h1, c1 = fp.fo_pool(gg[:, :3], cc)
            h2, cT = fp.fo_pool(gg[:, 3:], c1)
            h = torch.cat([h1, h2], 1)
        else:
            h, cT = fp.fo_pool(gg, cc)
        loss = (h * torch.arange(h.numel()).view(h.shape).sin()).sum() \
            + cT.sum()
        return (h, cT) + torch.autograd.grad(loss, (gg, cc))

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_shapes_are_checked():
    g, c0 = _gates_and_state()
    with pytest.raises(ValueError, match="does not match"):
        fp.fo_pool(g[..., :-1], c0)
    with pytest.raises(ValueError, match="empty sweep"):
        fp.fo_pool(g[:, :0], c0)


QRNN = ModelConfig(frame_sizes=(4, 4), n_rnn=2, dim=16, cond_dim=3,
                   cond_len=16, spk_dim=2, look_ahead=True, qrnn=True)


def test_pool_span_under_the_profiler_and_no_launch_on_the_cpu():
    params = tsr.init_params(QRNN, torch.Generator().manual_seed(0),
                             device="cpu")
    state = tsr.init_tier_state(QRNN, 2, device="cpu")
    data = torch.randint(0, 256, (2, 2 * QRNN.lookback + QRNN.lookback - 1))
    cond = torch.rand(2, 2, QRNN.effective_cond_dim)
    spk = torch.tensor([0, 1])
    before = (fp.fo_pool_forward.launches, fp.fo_pool_backward.launches)
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        tsr.predictor_apply(params, QRNN, data, True, cond, spk, state)
    assert len(profiling.records("qrnn.pool")) == QRNN.n_tiers * QRNN.n_rnn
    tsr.predictor_apply(params, QRNN, data, True, cond, spk, state)
    assert len(profiling.records("qrnn.pool")) == QRNN.n_tiers * QRNN.n_rnn
    assert (fp.fo_pool_forward.launches,
            fp.fo_pool_backward.launches) == before


def _model_dict(cfg):
    return {"frame_sizes": list(cfg.frame_sizes), "n_rnn": cfg.n_rnn,
            "dim": cfg.dim, "q_levels": cfg.q_levels, "ulaw": cfg.ulaw,
            "weight_norm": cfg.weight_norm, "variant": cfg.variant,
            "look_ahead": cfg.look_ahead, "cond_dim": cfg.cond_dim}


def test_qrnn_train_step_matches_the_reference():
    """Three TBPTT steps of the port's QRNN train step (state carried)
    against the plain reference's, float32, from the same weights and
    chunks: each loss, the first gradient's and the change's norms."""
    cfg, B, L = QRNN, 4, 2 * QRNN.lookback
    gen = torch.Generator().manual_seed(7)
    params = tsr.init_params(cfg, gen, device="cpu")
    for layer in (lay for tier in params["tiers"] for lay in tier["gru"]):
        layer["b"].uniform_(-0.5, 0.5, generator=gen)   # non-zero biases
    params0 = tree_map(torch.clone, params)
    audio = torch.randint(0, 256, (B, 3 * L + cfg.lookback), generator=gen)
    conds = torch.rand(B, 3 * (L // cfg.lookback) + 1,
                       cfg.effective_cond_dim, generator=gen)
    spk = torch.randint(0, cfg.spk_dim, (B,), generator=gen)
    chunks = []
    for k in range(3):
        s = k * L
        c0 = k * (L // cfg.lookback)
        chunks.append((audio[:, s:s + L + cfg.lookback - 1], k == 0,
                       audio[:, s + cfg.lookback:s + cfg.lookback + L],
                       conds[:, c0:c0 + L // cfg.lookback], spk))
    train = {"learning_rate": 1e-3, "grad_clip": 1.0}
    want = ref_qrnn.train_steps(_model_dict(cfg), train, params0, chunks)

    opt = make_optimizer(TrainConfig(seq_len=L, batch_size=B,
                                     learning_rate=1e-3, grad_clip=1.0))
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    state = tsr.init_tier_state(cfg, B, device="cpu")
    losses = []
    for i, (inp, reset, target, cond, s) in enumerate(chunks):
        params, opt_state, state, loss = step(params, opt_state, state, inp,
                                              reset, target, cond, s)
        losses.append(float(loss))
        if i == 0:
            grad = [float(torch.linalg.vector_norm(mu.double())) / 0.1
                    for mu in tree_leaves(opt_state["mu"])]
    change = [float(torch.linalg.vector_norm((p - p0).double()))
              for p, p0 in zip(tree_leaves(params), tree_leaves(params0))]
    for a, b in zip(losses, want["loss"]):
        assert abs(a - b) <= 2e-5 * abs(b)
    for got, ref in ((grad, want["grad"]), (change, want["change"])):
        med = statistics.median(ref)
        for a, b in zip(got, ref):
            assert abs(a - b) <= 1e-4 * max(b, med), (a, b)
