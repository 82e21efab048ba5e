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


# --------------------------------------------------------------------------
# the launch plan, the packed weights and the strided window
# --------------------------------------------------------------------------

SMEM = 232448        # the most shared memory a CTA of an H100 may ask for
BF16, F32 = torch.bfloat16, torch.float32


def _covered_once(plan, batch):
    lanes = [b for first, n in sw.plan_lanes(plan, batch)
             for b in range(first, first + n)]
    return lanes == list(range(batch))


@pytest.mark.parametrize("max_clusters", [0, 1, 8])
@pytest.mark.parametrize("batch", [1, 3, 128, 130, 1024])
def test_window_plan_canonical(batch, max_clusters):
    if max_clusters == 0:       # no cluster granted, no grid CTAs given
        with pytest.raises(ValueError, match="no kernel takes"):
            sw.window_plan(batch, 20, 256, 1024, BF16, max_clusters, SMEM)
        return
    plan = sw.window_plan(batch, 20, 256, 1024, BF16, max_clusters, SMEM)
    assert _covered_once(plan, batch)
    assert plan.smem_bytes <= SMEM
    shares = [n for _, n in sw.plan_lanes(plan, batch)]
    assert max(shares) == plan.lanes_per_cluster and min(shares) >= 1
    assert plan.path == "resident"
    assert plan.cluster == 16 and plan.subtile == sw.SUBTILE
    assert plan.clusters == min(max_clusters, -(-batch // sw.SUBTILE))
    assert max(shares) - min(shares) <= 1
    assert plan.smem_bytes == sw.resident_smem_bytes(20, 256, 1024, 16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("dim", [32, 1024, 2048])
def test_window_plan_by_width_and_type(dim, dtype):
    if dtype != BF16 or dim == 2048:    # no grid CTAs given
        with pytest.raises(ValueError, match="no kernel takes"):
            sw.window_plan(130, 20, 256, dim, dtype, 8, SMEM)
        return
    plan = sw.window_plan(130, 20, 256, dim, dtype, 8, SMEM)
    assert plan.path == "resident"
    assert _covered_once(plan, 130) and plan.smem_bytes <= SMEM
    assert plan.cluster == sw.resident_cluster(20, 256, dim, SMEM)
    assert dim // plan.cluster <= 64 and dim % (16 * plan.cluster) == 0


def test_window_plan_rejects_what_no_kernel_takes():
    with pytest.raises(TypeError):
        sw.window_plan(4, 20, 256, 1024, torch.float16, 8, SMEM)
    with pytest.raises(ValueError):
        sw.window_plan(0, 20, 256, 1024, BF16, 8, SMEM)
    with pytest.raises(ValueError):
        sw.window_plan(4, 20, 256, 1020, BF16, 8, SMEM)
    with pytest.raises(ValueError):        # not even one lane fits
        sw.window_plan(4, 20, 256, 1024, F32, 0, 1000, grid_ctas=132)


@pytest.mark.parametrize("dim,want", [(64, 1), (128, 2), (512, 8),
                                      (1024, 16), (1088, 0), (2048, 0)])
def test_resident_cluster_is_the_smallest_that_fits(dim, want):
    assert sw.resident_cluster(20, 256, dim, SMEM) == want
    if want:
        assert sw.resident_smem_bytes(20, 256, dim, want) <= SMEM
    # with too little shared memory no cluster holds the weights
    assert sw.resident_cluster(20, 256, dim, 1 << 14) == 0


def test_resident_smem_formula_at_the_canonical_shape():
    # 160 KB of weights, x and h (8 x 1032 bf16 each), logits (8 x 256
    # f32), the CTA's own noise (8 x 16 f32), partial sums (16 x 8 x 20
    # f32), 8 x 40 samples, four mbarriers
    want = (163840 + 2 * 16512 + 8192 + 512 + 10240 + 1280 + 32)
    assert sw.resident_smem_bytes(20, 256, 1024, 16) == want <= SMEM


def test_fragment_index_is_the_mma_operand_order():
    """Thread t's value e of a 16 x 16 tile A[m][k] = w[k][m]: rows
    t // 4 (+ 8), depths 2 (t % 4) + {0, 1} (+ 8), in the order a0..a3 of
    mma.m16n8k16's A operand."""
    depth, cols, cluster = 32, 64, 2
    idx = sw._fragment_index(depth, cols, cluster)
    assert idx.shape == (cluster, cols // cluster // 16, depth // 16, 32, 8)
    for r, tile, step, t, e in [(0, 0, 0, 0, 0), (1, 1, 1, 31, 7),
                                (0, 1, 0, 5, 2), (1, 0, 1, 18, 5)]:
        m = t // 4 + 8 * ((e // 2) % 2)
        k = 2 * (t % 4) + e % 2 + 8 * (e // 4)
        col = r * (cols // cluster) + tile * 16 + m
        assert int(idx[r, tile, step, t, e]) == (step * 16 + k) * cols + col
    assert sorted(idx.reshape(-1).tolist()) == list(range(depth * cols))


@pytest.mark.parametrize("dim,cluster", [(64, 1), (64, 4), (1024, 16)])
def test_pack_unpack_window_weights(dim, cluster):
    q = 256
    rng = np.random.RandomState(dim + cluster)
    wh = torch.from_numpy(rng.randn(dim, dim).astype(np.float32)).to(BF16)
    wo = torch.from_numpy(rng.randn(dim, q).astype(np.float32)).to(BF16)
    packed = sw.pack_window_weights(wh, wo, cluster)
    assert packed.shape == (cluster, (dim + q) // cluster * dim)
    assert packed.dtype == BF16 and packed.is_contiguous()
    back_h, back_o = sw.unpack_window_weights(packed, dim, q, cluster)
    # bit for bit
    assert torch.equal(back_h.view(torch.int16), wh.view(torch.int16))
    assert torch.equal(back_o.view(torch.int16), wo.view(torch.int16))
    # a CTA's slice is one contiguous row: exactly its columns of W_h, then
    # exactly its columns of W_o (packing element numbers shows which)
    ids_h = torch.arange(dim * dim, dtype=torch.int32).reshape(dim, dim)
    ids_o = torch.arange(dim * q, dtype=torch.int32).reshape(dim, q)
    ids = sw.pack_window_weights(ids_h, ids_o, cluster)
    mh, mo = dim // cluster, q // cluster
    for r in range(cluster):
        assert sorted(ids[r, :mh * dim].tolist()) == sorted(
            ids_h[:, r * mh:(r + 1) * mh].reshape(-1).tolist())
        assert sorted(ids[r, mh * dim:].tolist()) == sorted(
            ids_o[:, r * mo:(r + 1) * mo].reshape(-1).tolist())


def test_pack_rejects_a_cluster_that_cannot_split_the_columns():
    with pytest.raises(ValueError):
        sw.pack_window_weights(torch.zeros(64, 64), torch.zeros(64, 256), 8)
    with pytest.raises(ValueError):
        sw.unpack_window_weights(torch.zeros(2, 100), 64, 256, 2)


def test_resident_weights_are_for_cuda_tensors_only():
    assert sw.resident_weights(torch.zeros(64, 64, dtype=BF16),
                               torch.zeros(64, 256, dtype=BF16), 20) is None


@pytest.mark.parametrize("mode", ["noise", "seed"])
def test_wrapper_reads_a_strided_window_and_strided_slots(mode):
    """The window as the last fs0 columns of a wider buffer and the slot
    rows as a view of a wider tensor (neither copied) give what the
    contiguous call gives."""
    cfg = ModelConfig(frame_sizes=(8, 4), n_rnn=1, dim=16, cond_dim=5,
                      spk_dim=2)
    table, wh, bh, wo, bo, slots, buf, noise = torch_inputs(
        *kernel_inputs(cfg, 4, bias_scale=0.1))
    fs0 = buf.shape[1]
    wide = torch.cat([torch.full((4, 24), 7, dtype=torch.int32), buf], 1)
    window = wide[:, -fs0:]
    wide_slots = torch.cat([slots, torch.ones_like(slots)], 1)[:, :fs0]
    assert not window.is_contiguous() and not wide_slots.is_contiguous()
    kw = ({"noise": noise} if mode == "noise"
          else {"seed": torch.tensor([5], dtype=torch.int64)})
    want = sw.sample_window(table, wh, bh, wo, bo, slots, buf, **kw)
    got = sw.sample_window(table, wh, bh, wo, bo, wide_slots, window, **kw)
    assert torch.equal(got, want)
    assert window.data_ptr() == wide[:, -fs0:].data_ptr()

