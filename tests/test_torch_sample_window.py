"""The sample-window kernel's plain version vs the JAX Pallas kernel (run in
interpret mode on the CPU) on shared Gumbel noise: exact sample equality.
Plus the wrapper's CPU dispatch and argument checks. The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msnv_tpu.config import ModelConfig
from msnv_tpu.models.generate import fused_embed_conv
from msnv_tpu.models.samplernn import init_params
from msnv_tpu.ops.linear import dense_weight
from msnv_tpu.pallas.sample_kernel import make_sample_window
from msnv_tpu_torch.kernels import sample_window as sw
from torch_parity import t


def kernel_inputs(cfg, batch, seed=0, bias_scale=0.0):
    """JAX-layout kernel inputs (slots (fs0, B, dim), noise (fs0, B, q))."""
    params = init_params(jax.random.PRNGKey(seed), cfg)
    fused = fused_embed_conv(params["mlp"])
    fs0, q, dim = fused.shape
    rng = np.random.RandomState(seed)
    buf = rng.randint(0, q, (batch, fs0)).astype(np.int32)
    slots = rng.randn(fs0, batch, dim).astype(np.float32)
    table = np.asarray(fused).reshape(fs0 * q, dim)
    wh = np.asarray(dense_weight(params["mlp"]["hidden"])).T
    bh = (rng.randn(dim) * bias_scale).astype(np.float32)
    wo = np.asarray(dense_weight(params["mlp"]["out"])).T
    bo = (rng.randn(q) * bias_scale).astype(np.float32)
    u = rng.uniform(1e-6, 1.0, (fs0, batch, q))
    noise = (-np.log(-np.log(u))).astype(np.float32)
    return table, wh, bh, wo, bo, slots, buf, noise


def torch_inputs(table, wh, bh, wo, bo, slots, buf, noise):
    """The port's lane-major layout of the same inputs."""
    return (t(table), t(np.ascontiguousarray(wh)), t(bh),
            t(np.ascontiguousarray(wo)), t(bo),
            t(np.ascontiguousarray(slots.transpose(1, 0, 2))), t(buf),
            t(np.ascontiguousarray(noise.transpose(1, 0, 2))))


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("frame_sizes,tile_b", [((4, 4), 2), ((8, 4), 4),
                                                ((8, 4), 8)])
def test_reference_equals_pallas_interpret(frame_sizes, tile_b, noisy):
    cfg = ModelConfig(frame_sizes=frame_sizes, n_rnn=1, dim=16, cond_dim=5,
                      spk_dim=2)
    batch = 8
    args = kernel_inputs(cfg, batch, bias_scale=0.1)
    if not noisy:
        args = args[:-1] + (np.zeros_like(args[-1]),)
    table, wh, bh, wo, bo, slots, buf, noise = args
    fs0, q, dim = frame_sizes[0], cfg.q_levels, cfg.dim
    kern = make_sample_window(fs0, q, dim, batch, tile_b=tile_b,
                              interpret=True)
    want = np.asarray(kern(jnp.asarray(table), jnp.asarray(wh),
                           jnp.asarray(bh)[None], jnp.asarray(wo),
                           jnp.asarray(bo)[None], jnp.asarray(slots),
                           jnp.asarray(buf), jnp.asarray(noise)))
    got = sw.sample_window_reference(*torch_inputs(*args)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    targs = torch_inputs(*args)
    got_w = sw.sample_window(*targs[:-1], noise=targs[-1]).numpy()
    np.testing.assert_array_equal(got_w, want)


def test_bf16_reference_runs_in_weight_dtype():
    """bf16 weights: int32 samples in range, and on sharpened logits
    (argmax-dominant) nearly the same draws as the f32 version."""
    cfg = ModelConfig(frame_sizes=(8, 4), n_rnn=1, dim=16, cond_dim=5,
                      spk_dim=2)
    table, wh, bh, wo, bo, slots, buf, noise = torch_inputs(
        *kernel_inputs(cfg, 8, seed=3))
    wo = wo * 1e3
    bf = torch.bfloat16
    got = sw.sample_window_reference(table.to(bf), wh.to(bf), bh, wo.to(bf),
                                     bo, slots.to(bf), buf, noise)
    ref = sw.sample_window_reference(table, wh, bh, wo, bo, slots, buf,
                                     noise)
    assert got.dtype == torch.int32 and got.shape == (8, 8)
    assert int(got.min()) >= 0 and int(got.max()) < cfg.q_levels
    # a lane diverges from its first differing draw on (its window
    # differs), so compare the first draw of each lane
    assert (got[:, 0] != ref[:, 0]).float().mean() <= 0.25


def test_gumbel_noise_is_gumbel():
    g = torch.Generator().manual_seed(0)
    x = sw.gumbel_noise((200000,), g)
    assert torch.isfinite(x).all()
    # Gumbel(0, 1): mean = Euler-Mascheroni, variance = pi^2 / 6
    assert abs(float(x.mean()) - 0.5772) < 0.01
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03


def _small_args(batch=2, fs0=4, q=16, dim=8):
    rng = np.random.RandomState(0)
    return dict(
        table=torch.from_numpy(rng.randn(fs0 * q, dim).astype(np.float32)),
        wh=torch.zeros(dim, dim), bh=torch.zeros(dim),
        wo=torch.zeros(dim, q), bo=torch.zeros(q),
        slots=torch.zeros(batch, fs0, dim),
        buf=torch.zeros(batch, fs0, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["seed_shape", "both", "bo_shape",
                                 "buf_dtype", "slots_dtype", "noise_shape"])
def test_wrapper_rejects_bad_arguments(bad):
    a = _small_args()
    noise = torch.zeros(2, 4, 16)
    kw = {"noise": noise}
    if bad == "seed_shape":
        kw = {"seed": torch.zeros(2, dtype=torch.int64)}
    elif bad == "both":
        kw = {"noise": noise, "seed": torch.zeros(1, dtype=torch.int64)}
    elif bad == "bo_shape":
        a["bo"] = torch.zeros(15)
    elif bad == "buf_dtype":
        a["buf"] = a["buf"].long()
    elif bad == "slots_dtype":
        a["slots"] = a["slots"].double()
    elif bad == "noise_shape":
        kw = {"noise": torch.zeros(4, 2, 16)}
    with pytest.raises((ValueError, TypeError)):
        sw.sample_window(*a.values(), **kw)


def test_wrapper_counts_only_kernel_launches():
    """CPU calls run the plain version and do not count as launches."""
    a = _small_args()
    before = sw.sample_window.launches
    out = sw.sample_window(*a.values(), noise=torch.zeros(2, 4, 16))
    assert out.shape == (2, 4) and out.dtype == torch.int32
    assert sw.sample_window.launches == before


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_known_answers(ctr, key, want):
    """Philox-4x32-10 known-answer vectors (Salmon et al., Random123)."""
    as_t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    got = sw.philox4x32(*map(as_t, ctr), *map(as_t, key))
    assert tuple(int(x) for x in got) == want


def test_philox_noise_is_gumbel_and_seeded():
    seed = torch.tensor([123456789012345], dtype=torch.int64)
    x = sw.philox_gumbel_noise(seed, 64, 20, 256)
    assert x.shape == (64, 20, 256) and torch.isfinite(x).all()
    assert abs(float(x.mean()) - 0.5772) < 0.01
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03
    assert torch.equal(x, sw.philox_gumbel_noise(seed, 64, 20, 256))
    # a lane's draws do not depend on the batch it is in
    assert torch.equal(x[:8], sw.philox_gumbel_noise(seed, 8, 20, 256))
    assert not torch.equal(x, sw.philox_gumbel_noise(seed + 1, 64, 20, 256))


def test_cpu_seed_mode_is_reference_on_philox_noise():
    cfg = ModelConfig(frame_sizes=(8, 4), n_rnn=1, dim=16, cond_dim=5,
                      spk_dim=2)
    args = torch_inputs(*kernel_inputs(cfg, 4, bias_scale=0.1))
    seed = torch.tensor([42], dtype=torch.int64)
    got = sw.sample_window(*args[:-1], seed=seed)
    want = sw.sample_window_reference(
        *args[:-1], sw.philox_gumbel_noise(seed, 4, 8, cfg.q_levels))
    assert torch.equal(got, want)
