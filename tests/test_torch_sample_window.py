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


@pytest.mark.parametrize("max_clusters", [0, 1, 7, 8, 16])
@pytest.mark.parametrize("batch", [1, 3, 8, 19, 128, 130, 147, 1024])
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
    assert plan.cluster == 16
    assert plan.clusters == min(max_clusters, -(-batch // sw.SUBTILE))
    assert max(shares) - min(shares) <= 1
    assert plan.smem_bytes == sw.resident_smem_bytes(20, 256, 1024, 16,
                                                     plan.subtile)
    # every width fits at this shape: the fewest passes 32 lanes allow, at
    # the narrowest width that takes that many
    share = plan.lanes_per_cluster
    assert plan.subtile in sw.RESIDENT_WIDTHS
    assert sw.plan_passes(plan) == -(-share // 32)
    assert plan.subtile == 8 or \
        -(-share // (plan.subtile - 8)) > sw.plan_passes(plan)


# (B, clusters granted) -> (width of a pass, passes a cluster) at the
# canonical shape: as many clusters as granted, at least 8 lanes each
WIDTHS = {(1, 7): (8, 1), (8, 7): (8, 1), (19, 7): (8, 1),
          (128, 7): (24, 1), (147, 7): (24, 1), (1024, 7): (32, 5),
          (1, 16): (8, 1), (8, 16): (8, 1), (19, 16): (8, 1),
          (128, 16): (8, 1), (147, 16): (16, 1), (1024, 16): (32, 2)}


@pytest.mark.parametrize("batch,max_clusters", sorted(WIDTHS))
def test_window_plan_width_and_passes(batch, max_clusters):
    plan = sw.window_plan(batch, 20, 256, 1024, BF16, max_clusters, SMEM)
    assert (plan.subtile, sw.plan_passes(plan)) == \
        WIDTHS[batch, max_clusters]


def test_three_tier_windows_stay_8_wide():
    """128 lanes of the three-tier model (fs0 4, dim 512) over 16 clusters
    of 8 CTAs: 8 lanes a cluster, one pass of 8; over fewer clusters one
    wider pass."""
    plan = sw.window_plan(128, 4, 256, 512, BF16, 16, SMEM)
    assert (plan.cluster, plan.clusters, plan.subtile) == (8, 16, 8)
    assert sw.plan_passes(plan) == 1
    plan = sw.window_plan(128, 4, 256, 512, BF16, 8, SMEM)
    assert (plan.subtile, sw.plan_passes(plan)) == (16, 1)


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
        assert sw.resident_widths(20, 256, dim, want, SMEM)
    # with too little shared memory no cluster holds the weights
    assert sw.resident_cluster(20, 256, dim, 1 << 14) == 0


def test_resident_smem_formula_at_the_canonical_shape():
    # per width w: W_h's 16 steps a warp less the 4 w / 8 held in registers
    # in a pass wider than 8 (8 KB a step over the 16 warps; a pass of 8
    # holds none), the CTA's 64 rows of W_o (32 KB), the x rows (w x 1032
    # bf16; the CTA's h, w x 72 bf16, and each lane's best of each pair of
    # its columns, w x 8 x 8 B, lie over them: no h rows of all of dim),
    # the CTA's own noise (w x 16 f32), W_h's partial sums (4 parts of w x
    # 68 + 4 f32), the 16 parts of its logits that the cluster sends (w x
    # 20 + 4 f32 each; not over the x rows), two buffers of row sums (w x
    # 64 f32 each), the biases (80 f32), each CTA's best (w x 16 x 8 B), w x
    # 40 samples, five mbarriers; the parts of all 16 columns in one round
    for w in sw.RESIDENT_WIDTHS:
        held = w // 2 if w > 8 else 0
        assert w * (72 * 2 + 8 * 8) <= w * 2064
        want = ((16 - held) * 8192 + 32768 + w * 2064 + w * 64
                + 4 * (w * 272 + 16) + 16 * 4 * (w * 20 + 4) + 2 * w * 256
                + 320 + w * 128 + w * 160 + 40)
        assert sw.resident_smem_bytes(20, 256, 1024, 16, w) == want <= SMEM
        assert sw.resident_rounds(20, 256, 1024, 16, w) == 1
    # at 32 lanes the parts take 41 KB where the h rows took 66 KB
    assert 16 * 4 * (32 * 20 + 4) == 41216 and 32 * 1032 * 2 == 66048


# (fs0, q, dim, cluster): the two presets' windows (samplernn; three tiers)
PRESET_SHAPES = [(20, 256, 1024, 16), (4, 256, 512, 8)]


@pytest.mark.parametrize("fs0,q,dim,cluster", PRESET_SHAPES)
def test_every_width_fits_an_h100_at_the_presets(fs0, q, dim, cluster):
    assert sw.resident_cluster(fs0, q, dim, SMEM) == cluster
    assert sw.resident_widths(fs0, q, dim, cluster, SMEM) == \
        list(sw.RESIDENT_WIDTHS)
    for w in sw.RESIDENT_WIDTHS:
        smem = sw.resident_smem_bytes(fs0, q, dim, cluster, w)
        assert smem <= SMEM
        assert sw.resident_rounds(fs0, q, dim, cluster, w) == 1
        # the layout that sent h to every CTA, by the same formula: x and h
        # rows of all of dim, the logits' parts over the x rows where they
        # fit; every width takes less now
        assert smem < _h_broadcast_smem(fs0, q, dim, cluster, w)


def _h_broadcast_smem(fs0, q, dim, cluster, width):
    """Shared memory of a CTA of the resident kernel when each CTA owned q
    / cluster columns of W_o over all of dim and sent its columns of h to
    every CTA: x and h rows of all of dim, the partial logits of its
    columns (depth split over its warps) over the x rows where they fit."""
    mh, mo, ks = dim // cluster, q // cluster, dim // 16
    split_h, split_o = sw._depth_split(mh // 16, ks), sw._depth_split(
        mo // 16, ks)
    kreg = min(ks // split_h, 4 * width // 8 if width > 8 else 0)
    row = (dim + 8) * 2
    red_h = 4 * split_h * (width * (mh + 4) + 4)
    red_o = 4 * split_o * (width * (mo + 4) + 4)
    red = red_h if red_o <= width * row else max(red_h, red_o)
    total = ((mh // 16) * (ks - split_h * kreg) * 512 + mo * dim * 2
             + 2 * width * row + width * mo * 4 + red + 2 * width * mh * 4
             + (mh + mo) * 4 + width * (mo // 4) * 8 + width * cluster * 8
             + width * 2 * fs0 * 4)
    return -(-total // 16) * 16 + 32


def _h_broadcast_cluster_widths(fs0, q, dim):
    for c in sw.CLUSTER_SIZES:
        if (dim % (16 * c) or q % (16 * c) or dim // c > 64 or q // c > 256):
            continue
        widths = [w for w in sw.RESIDENT_WIDTHS if sw._width_ok(q, c, w)
                  and _h_broadcast_smem(fs0, q, dim, c, w) <= SMEM]
        if widths:
            return c, widths
    return 0, []


@pytest.mark.parametrize("fs0", [1, 4, 20, 64])
@pytest.mark.parametrize("q", [16, 64, 128, 256, 512, 1024])
def test_every_shape_keeps_its_cluster_and_widths(fs0, q):
    """Each shape that the resident kernel took when it sent h to every CTA
    takes the same cluster and can run passes of every width it could: the
    plan is the same (where q is large beside dim, with the partial logits
    in rounds)."""
    for dim in range(16, 1025, 16):
        older, widths = _h_broadcast_cluster_widths(fs0, q, dim)
        if not older:
            continue
        assert sw.resident_cluster(fs0, q, dim, SMEM) == older, dim
        assert set(widths) <= set(sw.resident_widths(fs0, q, dim, older,
                                                     SMEM)), dim


# (fs0, q, dim, cluster, width, rounds): windows whose parts of all of a
# CTA's logit columns do not fit beside the rest, and the three that do
ROUNDS = [(20, 512, 1024, 16, 16, 2), (20, 512, 1024, 16, 24, 2),
          (20, 1024, 768, 16, 8, 2), (20, 1024, 768, 16, 24, 4),
          (20, 1024, 512, 8, 8, 8), (20, 1024, 512, 8, 16, 2),
          (20, 512, 512, 8, 32, 2), (20, 512, 512, 8, 24, 1),
          (20, 256, 1024, 16, 32, 1), (4, 128, 512, 8, 32, 1)]


@pytest.mark.parametrize("fs0,q,dim,cluster,width,rounds", ROUNDS)
def test_partial_logits_come_in_the_fewest_rounds_that_fit(
        fs0, q, dim, cluster, width, rounds):
    """The parts of a CTA's logits arrive in as few rounds of its columns
    (whole 16-column tiles) as let the CTA fit an H100; each round halves
    the parts' buffer, and the CTA's bytes otherwise stay."""
    mo = q // cluster
    assert sw.resident_rounds(fs0, q, dim, cluster, width) == rounds
    assert mo // rounds % 16 == 0
    smem = sw.resident_smem_bytes(fs0, q, dim, cluster, width)
    assert smem <= SMEM
    parts = sw._logit_parts(q, dim, cluster)

    def part_bytes(r):
        return 4 * parts * (width * (mo // r + 4) + 4)
    if rounds > 1:
        # one round fewer would not fit
        assert smem + part_bytes(rounds // 2) - part_bytes(rounds) > SMEM


@pytest.mark.parametrize("fs0,q,dim,cluster,kib", [
    (20, 256, 1024, 16, 50.0), (4, 256, 512, 8, 16.5), (20, 256, 64, 1,
                                                          1160 / 1024)])
def test_push_bytes_formula(fs0, q, dim, cluster, kib):
    """What a lane's sample step writes into a resident cluster's shared
    memory: x (dim 2 C), the partial logits (q 4 C: C parts of each
    column), the bests (8 C^2). Below the h that every CTA received before
    (2 dim 2 C) where dim > 2 q, the same at dim = 2 q, above below it."""
    assert sw.resident_cluster(fs0, q, dim, SMEM) == cluster
    got = sw.resident_push_bytes(q, dim, cluster)
    assert got == dim * 2 * cluster + q * 4 * cluster + 8 * cluster ** 2
    assert got / 1024 == kib
    before = 2 * dim * 2 * cluster + 8 * cluster ** 2
    assert (got > before, got == before, got < before) == (
        dim < 2 * q, dim == 2 * q, dim > 2 * q)


def _older_cluster(fs0, q, dim):
    """The cluster the resident kernel took when it walked in passes of 8
    lanes with both weights and 8 lanes' logits in shared memory; 0:
    none."""
    for c in sw.CLUSTER_SIZES:
        mh, mo, ks = dim // c, q // c, dim // 16
        if (dim % (16 * c) or q % (16 * c) or mh > 64 or mo > 256):
            continue
        red = 4 * 8 * max(sw._depth_split(mh // 16, ks) * (mh + 4),
                          sw._depth_split(mo // 16, ks) * (mo + 4))
        smem = ((mh + mo) * dim * 2 + 2 * 8 * (dim + 8) * 2 + 8 * q * 4
                + 8 * mo * 4 + red + 8 * 2 * fs0 * 4)
        if -(-smem // 16) * 16 + 32 <= SMEM:
            return c
    return 0


@pytest.mark.parametrize("fs0", [1, 4, 20, 64])
@pytest.mark.parametrize("q", [16, 64, 256, 512, 1024])
def test_shapes_that_took_the_resident_kernel_still_do(fs0, q):
    """Every width that took the resident kernel with passes of 8 lanes
    still takes it; up to q 512 (every preset) with the same cluster, so
    the same split of both products and the same bits."""
    assert _older_cluster(20, 256, 1024) == 16
    for dim in range(16, 1025, 16):
        older = _older_cluster(fs0, q, dim)
        if not older:
            continue
        cluster = sw.resident_cluster(fs0, q, dim, SMEM)
        assert cluster and (cluster == older or q > 512), (dim, older)
        for batch in (1, 128, 1024):
            plan = sw.window_plan(batch, fs0, q, dim, BF16, 7, SMEM)
            assert plan.path == "resident" and plan.cluster == cluster


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


def test_row_fragment_index_is_the_mma_operand_order():
    """CTA r's rows of W_o: thread t's value e of tile `tile`, step `step`
    is A[m][k] = w[r depth / cluster + 16 step + k][16 tile + m], as in
    `_fragment_index`, over all of the columns."""
    depth, cols, cluster = 64, 32, 2
    idx = sw._row_fragment_index(depth, cols, cluster)
    assert idx.shape == (cluster, cols // 16, depth // cluster // 16, 32, 8)
    for r, tile, step, t, e in [(0, 0, 0, 0, 0), (1, 1, 1, 31, 7),
                                (0, 1, 0, 5, 2), (1, 0, 1, 18, 5)]:
        m = t // 4 + 8 * ((e // 2) % 2)
        k = 2 * (t % 4) + e % 2 + 8 * (e // 4)
        row = r * (depth // cluster) + step * 16 + k
        assert int(idx[r, tile, step, t, e]) == row * cols + tile * 16 + m
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
    # exactly the same rows of W_o, all q columns (packing element numbers
    # shows which)
    ids_h = torch.arange(dim * dim, dtype=torch.int32).reshape(dim, dim)
    ids_o = torch.arange(dim * q, dtype=torch.int32).reshape(dim, q)
    ids = sw.pack_window_weights(ids_h, ids_o, cluster)
    mh = dim // cluster
    for r in range(cluster):
        assert sorted(ids[r, :mh * dim].tolist()) == sorted(
            ids_h[:, r * mh:(r + 1) * mh].reshape(-1).tolist())
        assert sorted(ids[r, mh * dim:].tolist()) == sorted(
            ids_o[r * mh:(r + 1) * mh, :].reshape(-1).tolist())


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

